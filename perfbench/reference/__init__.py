"""The plain reference: a frozen copy of the port's pipeline
(``speech_diarization_tpu_torch`` at commit c463948) with both CUDA kernels
replaced by their plain float32 definitions, run at float32 with TF32 off.
It imports neither JAX, the JAX package nor the port; it reads the same
checkpoints and waveforms the program gets and recomputes everything else.
See ``perfbench/README.md`` for what was changed from the copy."""
