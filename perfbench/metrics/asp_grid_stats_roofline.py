"""Kernel K1 (``csrc/asp_grid.cu``, both ``__global__`` functions): the
least time of every launch in the window, by the copied ``ops/cost.py``
(``asp_grid_work`` at the net's own attention width, ``bound``), over the
profiler's device time of the kernel's functions, in %."""
from perfbench.reference.ops import cost

KERNELS = ("asp_preproj_kernel", "asp_window_kernel")
N_ARGS = 18     # x, t_f, first_f, cc, bw, w1x, s_bn, t_bn, w2, a_dim, hop_f,
                # win_f, n_windows, n_rows, x_t, hx, out, stream


def read(ctx):
    a_net = ctx.config.get("encoder", {}).get("net", {}).get("att_channels")
    bound_ms = 0.0
    for name, args in ctx.launches:
        if name != "asp_grid_stats" or len(args) != N_ARGS:
            continue
        cc, a_dim, hop_f, win_f, n_windows = args[3], args[9], args[10], args[11], args[12]
        w = cost.asp_grid_work(cc, min(a_dim, a_net or a_dim), hop_f, win_f, n_windows)
        bound_ms += cost.bound(w["bytes"], w["ops"])[0]
    dev_s = sum(v[0] for k, v in ctx.kernels.items() if any(n in k for n in KERNELS))
    if bound_ms <= 0 or dev_s <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * dev_s)
