"""Host I/O: audio decode and WAV writing, the RTTM / JSON / SRT / CSV
writers, speaker stems and the directory walk."""
from .audio import read_audio, read_wav, write_wav
from .stems import extract_speaker_stems
from .walk import expand_audios
from .writers import relabel_speakers, save_csv, save_json, save_srt, write_rttm

__all__ = [
    "read_audio",
    "write_wav",
    "read_wav",
    "write_rttm",
    "save_json",
    "save_srt",
    "save_csv",
    "relabel_speakers",
    "extract_speaker_stems",
    "expand_audios",
]
