"""Build both CUDA kernels of the PyTorch port, print the compiler's report
(registers, shared memory, spills) and hold each kernel against its plain
version at the main-path shapes and at ragged ones, with times per wrapper
call (CUDA events) and per ``__global__`` function (``torch.profiler``).  A
short first call for a new or edited kernel; ``chip_smoke.py`` is the full
check.

    python3 scripts/torch_kernel_check.py [KERNEL=SOURCE.cu ...]

``KERNEL=SOURCE.cu`` (``asp_grid_stats`` or ``fused_log_mel``) builds that
kernel from another source with the same C entry for this run: a variant
is checked and timed without replacing the kernel in ``csrc/``.
``--widths`` also checks and times the pooling at the other shipped
attention widths (``ecapa_proto_small.npz``: A 32 padded to 64, CC 384;
``ecapa_synthetic_full_stream.npz``: A 128, CC 1536) and the log-mel on the
windowed grid's batch (512 rows of 32,000 samples at a 1,600-sample
stride) at 40 and 80 mels.

It also disassembles the built libraries (``cuobjdump -sass``) and prints,
per ``__global__`` function, its instruction count and the length of its
longest loop (for K1's window kernel: the per-tile loop).

Needs a CUDA card.  Inputs are random (seeded); tolerances are
``chip_smoke.py``'s.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sass_report(lib: Path) -> None:
    """Instruction count and longest backward-branch span per function."""
    dump = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", func)]
        loop = 0
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loop = max(loop, (addr - int(m.group(1), 16)) // 16 + 1)
        name = subprocess.run(["c++filt", func.split("\n")[0].strip()],
                              capture_output=True, text=True).stdout.strip()
        print(f"sass: {len(ins):5d} instructions, longest loop {loop:5d}  "
              f"{name[:70]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from speech_diarization_tpu_torch.dsp.mel import (
        _log_mel_1d, _log_mel_batched, fused_log_mel,
    )
    from speech_diarization_tpu_torch.models.ecapa import (
        _asp_grid_stats_plain, asp_grid_stats,
    )
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder
    from speech_diarization_tpu_torch.ops import kernels

    widths = "--widths" in sys.argv[1:]
    for arg in sys.argv[1:]:
        if arg == "--widths":
            continue
        name, _, src = arg.partition("=")
        kernels.KERNELS[name] = (str(Path(src).resolve()), *kernels.KERNELS[name][1:])
        print(f"{name}: built from {src}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, text in kernels.build().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"{name}: {line.strip()}")
    for name in kernels.KERNELS:
        sass_report(kernels._lib_path(name))
    dev = torch.device("cuda")
    enc = load_speaker_encoder(ROOT / "weights" / "ecapa_robust_stream.npz",
                               dtype=torch.bfloat16).to(dev).eval()
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        y = (0.3 * torch.randn(1118400, generator=g)).to(dev)
        out, ref = fused_log_mel(y, n_mels=40), _log_mel_1d(y, n_mels=40)
        torch.cuda.synchronize()
        print(f"fused_log_mel: max abs err {(out - ref).abs().max().item():.3e} "
              f"of max {ref.abs().max().item():.3f}")
        # the overlap detector's batch: 24 windows of 5 s every 2.5 s, read
        # in place from one signal
        yb = y[64000:64000 + 23 * 40000 + 80000].unfold(0, 80000, 40000)
        out, ref = fused_log_mel(yb, n_mels=40), _log_mel_batched(yb, n_mels=40)
        torch.cuda.synchronize()
        print(f"fused_log_mel {tuple(yb.shape)} strides {yb.stride()}: max abs "
              f"err {(out - ref).abs().max().item():.3e} of max "
              f"{ref.abs().max().item():.3f}")
        x = torch.randn(768, 6991, generator=g).to(dev).to(torch.bfloat16)
        a = enc.net.k1_inputs(x, 400, 10, 201, 600)
        out, ref = asp_grid_stats(*a), _asp_grid_stats_plain(*a)
        torch.cuda.synchronize()
        print(f"asp_grid_stats: max abs err {(out - ref).abs().max().item():.3e} "
              f"of max {ref.abs().max().item():.3f}")
        chip_smoke.ragged_sweep(enc, dev)
        if widths:
            for w_name in ("ecapa_proto_small.npz",
                           "ecapa_synthetic_full_stream.npz"):
                e = load_speaker_encoder(ROOT / "weights" / w_name,
                                         dtype=torch.bfloat16).to(dev).eval()
                # the main path's 201 rows, and 450 rows (three chunks of
                # 208, the running state)
                for win_f, n_w in ((201, 600), (450, 50)):
                    xw = torch.randn(e.net.cat_channels, 400 + 10 * n_w + win_f,
                                     generator=g).to(dev).to(torch.bfloat16)
                    aw = e.net.k1_inputs(xw, 400, 10, win_f, n_w)
                    out, ref = asp_grid_stats(*aw), _asp_grid_stats_plain(*aw)
                    torch.cuda.synchronize()
                    print(f"asp_grid_stats {w_name} (A {e.net.att_channels}, "
                          f"padded {aw[2].shape[0]}, CC {e.net.cat_channels}) "
                          f"win_f {win_f}: max abs err "
                          f"{(out - ref).abs().max().item():.3e} of max "
                          f"{ref.abs().max().item():.3f}")
                    if win_f == 201:
                        a201 = aw
                k1w = chip_smoke.cuda_time_ms(lambda: asp_grid_stats(*a201), 50)
                print(f"asp_grid_stats {w_name}: {k1w:.4f} ms for 600 windows")
            yw = y[:511 * 1600 + 32000].unfold(0, 32000, 1600)
            for n_mels in (40, 80):
                out = fused_log_mel(yw, n_mels=n_mels)
                ref = _log_mel_batched(yw, n_mels=n_mels)
                torch.cuda.synchronize()
                t_w = chip_smoke.cuda_time_ms(
                    lambda: fused_log_mel(yw, n_mels=n_mels), 20)
                print(f"fused_log_mel {tuple(yw.shape)} strides {yw.stride()} "
                      f"{n_mels} mels: max abs err "
                      f"{(out - ref).abs().max().item():.3e} of max "
                      f"{ref.abs().max().item():.3f}; {t_w:.4f} ms")
        for _ in range(2):
            k2 = chip_smoke.cuda_time_ms(lambda: fused_log_mel(y, n_mels=40), 50)
            k2b = chip_smoke.cuda_time_ms(lambda: fused_log_mel(yb, n_mels=40), 50)
            k1 = chip_smoke.cuda_time_ms(lambda: asp_grid_stats(*a), 50)
            print(f"fused_log_mel {k2:.4f} ms, batch of 24 {k2b:.4f} ms, "
                  f"asp_grid_stats {k1:.4f} ms")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused_log_mel(y, n_mels=40)
                asp_grid_stats(*a)
            for _ in range(10):
                fused_log_mel(yb, n_mels=40)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.count >= 10:
                print(f"{e.device_time_total / e.count / 1e3:9.4f} ms  "
                      f"x{e.count}  {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
