"""Kernel K2 (``csrc/fused_fbank.cu``): the least time of every launch in
the window, by the copied ``ops/cost.py`` (``fused_log_mel_work``, its
float32-accurate DFT counted as three TF32 products, ``bound``), over the
profiler's device time of ``fused_log_mel_kernel``, in %."""
from perfbench.reference.ops import cost

KERNELS = ("fused_log_mel_kernel",)
N_ARGS = 16     # y, n_batch, y_stride, t, basis, n_ksteps, mel_idx, mel_w, nnz,
                # n_fft, hop, n_mels, eps, out, n_frames, stream
SAMPLE_RATE = 16000


def read(ctx):
    bound_ms = 0.0
    for name, args in ctx.launches:
        if name != "fused_log_mel" or len(args) != N_ARGS:
            continue
        n_batch, stride, t = args[1], args[2], args[3]
        n_fft, n_mels, n_frames = args[9], args[11], args[14]
        w = cost.fused_log_mel_work(n_batch * n_frames, n_mels,
                                    min(n_batch * t, (n_batch - 1) * stride + t),
                                    n_fft, SAMPLE_RATE)
        bound_ms += cost.bound(w["bytes"], w["ops"])[0]
    dev_s = sum(v[0] for k, v in ctx.kernels.items() if any(n in k for n in KERNELS))
    if bound_ms <= 0 or dev_s <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * dev_s)
