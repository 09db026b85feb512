"""Interactive web UI (gradio): upload audio, tune sliders, view the
waveform with coloured speaker spans and a segment table.

The JAX package's ``webui.py`` on the port's pipeline: the sliders hydrate
the config schema (:func:`_ui_config`), so every knob reaches the pipeline.
gradio is an optional dependency: :func:`build_ui` raises a clear error
without it.  :func:`run_diarize_ui` draws with matplotlib and tabulates with
pandas, imported when it is called.  The pipeline runs on the card unless
``device='cpu'``.

    python -m speech_diarization_tpu_torch.webui
"""
from __future__ import annotations

import numpy as np

SPEAKER_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def normalize_gradio_audio(audio_input) -> tuple[np.ndarray, int]:
    """(sr, int16/float ndarray) -> (float32 mono [T], sr): the first
    channel of a [T, C] array, int samples scaled by 1/32768."""
    sr, y = audio_input
    if y.ndim == 2:
        y = y[:, 0]
    if y.dtype.kind == "i":
        y = y.astype(np.float32) / 32768.0
    return y.astype(np.float32), sr


def _ui_config(vad_on, vad_off, min_speech_ms, min_silence_ms, speech_pad_ms,
               scd_thr, cluster_method, max_speakers, merge_gap_s,
               merge_maxturn_s, merge_mincos, reseg, denoise=False):
    """The sliders as a :class:`DiarizationConfig` (the JAX UI's mapping)."""
    from .config import (
        ClusterConfig, DiarizationConfig, EnhanceConfig, MergeConfig,
        ResegConfig, ScdConfig, VadConfig,
    )

    return DiarizationConfig(
        vad=VadConfig(on_threshold=vad_on, off_threshold=vad_off,
                      min_speech_ms=min_speech_ms, min_silence_ms=min_silence_ms,
                      speech_pad_ms=speech_pad_ms),
        scd=ScdConfig(peak_z_threshold=scd_thr),
        cluster=ClusterConfig(method=cluster_method, max_speakers=int(max_speakers)),
        reseg=ResegConfig(enabled=bool(reseg)),
        merge=MergeConfig(max_gap_s=merge_gap_s, max_turn_s=merge_maxturn_s,
                          min_cos=merge_mincos),
        # 'auto' scope: the denoiser engages only when the file measures
        # noisy, so leaving the box ticked costs nothing on clean audio
        enhance=EnhanceConfig(enabled=bool(denoise), scope="auto"),
    )


def run_diarize_ui(
    audio,
    vad_on, vad_off, min_speech_ms, min_silence_ms, speech_pad_ms,
    scd_thr, cluster_method, max_speakers, merge_gap_s, merge_maxturn_s,
    merge_mincos, reseg, denoise=False, device=None,
):
    """Diarize the uploaded audio with the sliders' config -> (matplotlib
    figure of the waveform with speaker spans, pandas table of segments)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    from .io.writers import relabel_speakers
    from .pipelines.diarize import DiarizationPipeline

    y, sr = normalize_gradio_audio(audio)
    cfg = _ui_config(vad_on, vad_off, min_speech_ms, min_silence_ms,
                     speech_pad_ms, scd_thr, cluster_method, max_speakers,
                     merge_gap_s, merge_maxturn_s, merge_mincos, reseg, denoise)
    result = DiarizationPipeline(cfg, device=device)((y, sr))
    entries = relabel_speakers(result.segments)
    df = pd.DataFrame([
        {"idx": i + 1, "start": e["start"], "end": e["end"],
         "dur": round(e["end"] - e["start"], 3), "speaker": e["speaker"]}
        for i, e in enumerate(entries)
    ])

    t = np.arange(len(y)) / sr
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(t, y, linewidth=0.6)
    for seg, spk in zip(entries, result.segments.spks):
        ax.axvspan(seg["start"], seg["end"], alpha=0.25,
                   color=SPEAKER_COLORS[max(int(spk), 0) % len(SPEAKER_COLORS)])
    ax.set_xlim(0, max(1e-3, t[-1]))
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title("Waveform with diarization spans")
    fig.tight_layout()
    return fig, df


def build_ui():
    """The gradio Blocks app; raises ``RuntimeError`` without gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; the web UI is an "
            "optional frontend — use the `sdtpu` CLI instead"
        ) from e

    with gr.Blocks(title="Speaker diarization viewer") as demo:
        gr.Markdown("## Speaker diarization — interactive viewer")
        audio = gr.Audio(sources=["upload"], type="numpy", label="audio")
        with gr.Accordion("parameters", open=False):
            with gr.Row():
                vad_on = gr.Slider(0.3, 0.9, 0.6, step=0.01, label="VAD on threshold")
                vad_off = gr.Slider(0.2, 0.8, 0.4, step=0.01, label="VAD off threshold")
                min_speech = gr.Slider(50, 600, 250, step=10, label="min speech (ms)")
                min_sil = gr.Slider(30, 500, 100, step=10, label="min silence (ms)")
                pad = gr.Slider(0, 200, 40, step=10, label="speech pad (ms)")
            with gr.Row():
                scd_thr = gr.Slider(0.3, 2.0, 1.0, step=0.01, label="SCD z threshold")
                method = gr.Dropdown(["spectral", "ahc", "hdbscan", "hdbscan2"],
                                     value="spectral", label="clustering")
                max_spk = gr.Slider(1, 10, 8, step=1, label="max speakers")
                reseg = gr.Checkbox(value=True, label="frame reassignment")
                denoise = gr.Checkbox(
                    value=False,
                    label="denoise if noisy (GTCRN, auto-engaged)")
            with gr.Row():
                merge_gap = gr.Slider(0.01, 10.0, 0.5, step=0.01, label="merge gap (s)")
                maxturn = gr.Slider(2.0, 60.0, 30.0, step=0.5, label="max turn (s)")
                mincos = gr.Slider(0.1, 0.99, 0.8, step=0.01, label="merge min cosine")
        btn = gr.Button("Diarize")
        fig = gr.Plot(label="waveform + spans")
        table = gr.Dataframe(label="segments", interactive=False)
        btn.click(
            fn=run_diarize_ui,
            inputs=[audio, vad_on, vad_off, min_speech, min_sil, pad, scd_thr,
                    method, max_spk, merge_gap, maxturn, mincos, reseg,
                    denoise],
            outputs=[fig, table],
        )
    return demo


def launch(**kwargs):
    """Build the UI and serve it (gradio's ``launch`` keyword arguments)."""
    build_ui().launch(**kwargs)


if __name__ == "__main__":
    launch()
