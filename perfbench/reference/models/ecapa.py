"""ECAPA-TDNN speaker embedder on the streaming grid, and kernel K1.

``EcapaTdnn`` keeps the JAX package's math and cast points: weights stay
float32 and are cast to the compute dtype at each convolution
(``_conv_bn_apply`` and the SE gate); BatchNorm scale/shift are computed in
float32 and cast to the activation dtype; pooling statistics are float32.

Holds kernel K1 and its plain version:

* :func:`_asp_grid_stats_plain` — the plain PyTorch version of the per-window
  attentive statistics, with the kernel's arithmetic (bf16 operands, float32
  accumulation, folded inference BatchNorm).
* :func:`asp_grid_stats` — the wrapper of ``csrc/asp_grid.cu`` (the port of
  the Pallas ``asp_grid_stats``).  On a CPU tensor it returns the plain
  version; on a CUDA tensor it launches the kernel or raises.

``EcapaTdnn.embed_utterances`` / ``asp_head`` and ``EcapaModel.encode_batch``
are the per-utterance encoder of the windowed grid (plain PyTorch; its
log-mel goes through kernel K2).  ``EcapaTdnn.asp_head_grid`` is the decomposed grid head in the net's dtype,
which is what the JAX package runs on the CPU; ``asp_head_grid_kernel``
goes through K1 (bf16 operands even for a float32 net, as the Pallas
kernel), which is what runs on the card.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cost, kernels


def current_group():
    """No mesh in the reference: train-mode statistics are local."""
    return None


from .layers import batch_norm_apply, conv1d_torch, sliding_mean_time


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class ConvBN(nn.Module):
    """SpeechBrain TDNNBlock: conv (reflect 'same' padding) -> ReLU -> BN."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.w = _param(c_out, c_in, k)
        self.b = _param(c_out)
        self.bn_gamma = _param(c_out)
        self.bn_beta = _param(c_out)
        self.bn_mean = _param(c_out)
        self.bn_var = _param(c_out)

    def forward(self, x: torch.Tensor, dilation: int = 1, padding: int = 0,
                act: bool = True, train: bool = False) -> torch.Tensor:
        if padding > 0:
            x = F.pad(x, (padding, padding), mode="reflect")
        # cast point: weights to the activation dtype at every conv
        x = conv1d_torch(x, self.w.to(x.dtype), self.b.to(x.dtype),
                         dilation=dilation)
        if act:
            x = F.relu(x)
        if train:
            return batch_norm_apply(x, *batch_stats(x, (0, 2)), self.bn_gamma,
                                    self.bn_beta)
        return batch_norm_apply(x, self.bn_mean, self.bn_var, self.bn_gamma,
                                self.bn_beta)


def batch_stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm statistics: float32 mean and biased variance
    (divided by n, as ``jnp.var``) over ``dims``.  Inside a shard of a mesh
    step (``parallel/collective.py``) they are those of the whole dp
    batch, merged from every shard's count, mean and squared deviations,
    as the JAX jit reduces them over the sharded batch; never per
    replica."""
    x32 = x.float()
    shard = current_group()
    if shard is not None:
        group, rank = shard
        return group.mean_var(rank, x32, dims)
    return x32.mean(dim=dims), x32.var(dim=dims, correction=0)


class BNStats(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = _param(c)
        self.beta = _param(c)
        self.mean = _param(c)
        self.var = _param(c)


class SERes2Block(nn.Module):
    def __init__(self, c: int, scale: int, se_channels: int):
        super().__init__()
        width = c // scale
        self.scale = scale
        self.conv1 = ConvBN(c, c, 1)
        self.res2 = nn.ModuleList(ConvBN(width, width, 3) for _ in range(scale - 1))
        self.conv2 = ConvBN(c, c, 1)
        self.se_w1 = _param(se_channels, c, 1)
        self.se_b1 = _param(se_channels)
        self.se_w2 = _param(c, se_channels, 1)
        self.se_b2 = _param(c)

    def forward(self, x: torch.Tensor, dilation: int,
                se_win: int | None = None, train: bool = False) -> torch.Tensor:
        residual = x
        y = self.conv1(x, train=train)
        groups = torch.chunk(y, self.scale, dim=1)
        outs = [groups[0]]
        prev = None
        for i in range(1, self.scale):
            inp = groups[i] if prev is None else groups[i] + prev
            prev = self.res2[i - 1](inp, dilation=dilation, padding=dilation,
                                    train=train)
            outs.append(prev)
        y = self.conv2(torch.cat(outs, dim=1), train=train)
        # squeeze-excitation: utterance mean, or in streaming mode a sliding
        # mean so each frame's gate matches an isolated se_win crop
        dt = y.dtype
        zm = y.mean(dim=2, keepdim=True) if se_win is None \
            else sliding_mean_time(y, se_win)
        z = F.relu(conv1d_torch(zm, self.se_w1.to(dt), self.se_b1.to(dt)))
        z = torch.sigmoid(conv1d_torch(z, self.se_w2.to(dt), self.se_b2.to(dt)))
        return residual + y * z


class EcapaTdnn(nn.Module):
    """ECAPA-TDNN: fbank [B, T, n_mels] -> [B, 3C, T] trunk features ->
    per-window attentive-stats embeddings."""

    def __init__(self, n_mels: int = 80, channels: int = 512, emb_dim: int = 192,
                 scale: int = 8, se_channels: int = 128, att_channels: int = 128,
                 dilations: tuple[int, ...] = (2, 3, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_mels = n_mels
        self.channels = channels
        self.emb_dim = emb_dim
        self.scale = scale
        self.se_channels = se_channels
        self.att_channels = att_channels
        self.dilations = tuple(dilations)
        self.dtype = dtype
        self.cat_channels = cc = channels * len(self.dilations)
        a = att_channels
        self.stem = ConvBN(n_mels, channels, 5)
        self.block = nn.ModuleList(SERes2Block(channels, scale, se_channels)
                                   for _ in self.dilations)
        self.mfa = ConvBN(cc, cc, 1)
        self.att_w1 = _param(a, 3 * cc, 1)
        self.att_b1 = _param(a)
        self.att_bn = BNStats(a)
        self.att_w2 = _param(cc, a, 1)
        self.att_b2 = _param(cc)
        self.post_bn = BNStats(2 * cc)
        self.fc_w = _param(emb_dim, 2 * cc, 1)
        self.fc_b = _param(emb_dim)
        # K1's constants follow the weights: made now and again after every
        # load_state_dict
        self.fold_k1()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.fold_k1())

    def trunk(self, feats: torch.Tensor, se_win: int | None = None,
              train: bool = False) -> torch.Tensor:
        """feats [B, T, n_mels] -> [B, 3C, T] post-MFA features (compute
        dtype).  Shift-invariant when ``se_win`` is set (streaming mode).
        ``train``: every BatchNorm on the batch's statistics over (batch,
        time) instead of its running ones."""
        x = feats.transpose(1, 2).to(self.dtype)
        x = self.stem(x, padding=2, train=train)
        outs = []
        for blk, d in zip(self.block, self.dilations):
            x = blk(x, d, se_win=se_win, train=train)
            outs.append(x)
        return self.mfa(torch.cat(outs, dim=1), train=train)

    def embed_utterances(self, feats: torch.Tensor,
                         train: bool = False) -> torch.Tensor:
        """Per-utterance embeddings: fbank [B, T, n_mels] -> [B, emb_dim]
        float32 (trunk with utterance-mean SE, then :meth:`asp_head`);
        ``train``: train-mode BatchNorm throughout (the JAX ``apply(...,
        train=True)``)."""
        return self.asp_head(self.trunk(feats, train=train), train=train)

    def asp_head(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Attentive-stats pooling with global context over each
        utterance's frames, then post-BN and the embedding layer: trunk
        features [B, CC, T] -> [B, emb_dim] float32.  The context and the
        attention convolutions in the net's dtype, the softmax and the
        statistics in float32 (SpeechBrain semantics: eps 1e-12, the
        E[(x - mu)^2] form).  Plain PyTorch, as it is plain XLA in the JAX
        package."""
        eps = 1e-12
        dt = self.dtype
        x32 = x.float()
        mu_g = x32.mean(dim=2, keepdim=True)
        sd_g = torch.sqrt(torch.clamp(
            ((x32 - mu_g) ** 2).mean(dim=2, keepdim=True), min=eps))
        ctx = torch.cat([x32, mu_g.expand_as(x32), sd_g.expand_as(x32)],
                        dim=1).to(dt)
        a = F.relu(conv1d_torch(ctx, self.att_w1.to(dt), self.att_b1.to(dt)))
        ab = self.att_bn
        mean_var = batch_stats(a, (0, 2)) if train else (ab.mean, ab.var)
        a = torch.tanh(batch_norm_apply(a, *mean_var, ab.gamma, ab.beta))
        a = conv1d_torch(a, self.att_w2.to(dt), self.att_b2.to(dt)).float()
        p = torch.softmax(a, dim=2)                                 # [B, CC, T]
        mu = (p * x32).sum(dim=2)
        sd = torch.sqrt(torch.clamp(
            (p * (x32 - mu[:, :, None]) ** 2).sum(dim=2), min=eps))
        return self._stats_to_emb(torch.cat([mu, sd], dim=1), train=train)

    def _stats_to_emb(self, stats: torch.Tensor,
                      train: bool = False) -> torch.Tensor:
        pb = self.post_bn
        mean_var = batch_stats(stats, 0) if train else (pb.mean, pb.var)
        stats = batch_norm_apply(stats, *mean_var, pb.gamma, pb.beta)
        return conv1d_torch(stats[:, :, None], self.fc_w, self.fc_b)[:, :, 0].float()

    def _window_context(self, x: torch.Tensor, first_f: int, hop_f: int,
                        win_f: int, n_windows: int):
        """Per-window global-context mean/std [..., W, CC] of x [..., CC,
        T_f] from two float32 prefix sums over each row's frames."""
        eps = 1e-12
        x32 = x.float()
        starts = first_f + hop_f * torch.arange(n_windows, device=x.device)
        cs1 = F.pad(torch.cumsum(x32, dim=-1), (1, 0))
        cs2 = F.pad(torch.cumsum(x32 * x32, dim=-1), (1, 0))
        s1 = cs1[..., starts + win_f] - cs1[..., starts]
        s2 = cs2[..., starts + win_f] - cs2[..., starts]
        mu_g = s1.transpose(-1, -2) / win_f
        sd_g = torch.sqrt(torch.clamp(s2.transpose(-1, -2) / win_f
                                      - mu_g * mu_g, min=eps))
        return mu_g, sd_g, starts

    def asp_head_grid(self, x: torch.Tensor, first_f: int, hop_f: int,
                      win_f: int, n_windows: int, train: bool = False) -> torch.Tensor:
        """Decomposed sliding-grid ASP in the net's dtype: x [CC, T_f] ->
        [W, emb_dim], or a batch of rows [B, CC, T_f] -> [B, W, emb_dim]
        (the JAX ``vmap`` of it).  The JAX package's ``asp_head_grid``:
        plain PyTorch, differentiable, which is what training runs.
        ``train``: the attention and post BatchNorms on the statistics of
        each row's windows (of a row at a time, as under the JAX ``vmap``)."""
        if train and x.ndim == 3:
            return torch.stack([self.asp_head_grid(r, first_f, hop_f, win_f,
                                                   n_windows, train=True)
                                for r in x])
        eps = 1e-12
        cc = x.shape[-2]
        dt = self.dtype
        mu_g, sd_g, starts = self._window_context(x, first_f, hop_f, win_f,
                                                  n_windows)
        w1 = self.att_w1[..., 0]
        w1x, w1m, w1s = w1[:, :cc], w1[:, cc:2 * cc], w1[:, 2 * cc:]
        hx = w1x.to(dt) @ x.to(dt)                                  # [.., A, T_f]
        bw = (mu_g.to(dt) @ w1m.to(dt).T + sd_g.to(dt) @ w1s.to(dt).T
              + self.att_b1.to(dt))                                 # [.., W, A]
        idx = starts[:, None] + torch.arange(win_f, device=x.device)[None, :]
        # windows of all rows as one batch: [N, A, win]
        a = F.relu(hx[..., idx].movedim(-3, -2) + bw[..., None])
        a = a.reshape(-1, *a.shape[-2:])
        ab = self.att_bn
        mean_var = batch_stats(a, (0, 2)) if train else (ab.mean, ab.var)
        a = torch.tanh(batch_norm_apply(a, *mean_var, ab.gamma, ab.beta))
        # logits with float32 accumulation and output (operands in dt)
        w2 = self.att_w2[..., 0].to(dt).float()
        e = torch.einsum("ca,wat->wct", w2, a.float())
        e = e + self.att_b2.float()[None, :, None]
        p = torch.softmax(e, dim=2)                                 # [N, CC, win]
        xw = x[..., idx].movedim(-3, -2).reshape(-1, cc, win_f).float()
        mu = (p * xw).sum(-1)
        m2 = (p * xw * xw).sum(-1)
        sd = torch.sqrt(torch.clamp(m2 - mu * mu, min=eps))
        emb = self._stats_to_emb(torch.cat([mu, sd], dim=1), train=train)
        return emb.reshape(*x.shape[:-2], n_windows, emb.shape[-1])

    def fold_k1(self) -> None:
        """K1's constants, made from the weights at construction and after
        every ``load_state_dict`` (they are buffers, so they move with the
        module; after optimizer steps they are stale until this runs
        again, which the training recipes do at their end): the
        attention pre-projection split into its feature, mean and std parts
        and its bias, inference BN folded to a scale and shift, all float32,
        and the feature part and the logits projection in bf16, the kernel's
        operand type.  The attention width is zero-padded to a multiple of
        64, the kernel's slice: a padded unit gives tanh(relu(0) * s + 0) =
        0 and meets a zero column of ``w2``, so the stats are unchanged."""
        with torch.no_grad():
            consts = self._k1_constants()
        for name, t in consts.items():
            self.register_buffer(name, t, persistent=False)

    def _k1_constants(self) -> dict[str, torch.Tensor]:
        cc, a = self.cat_channels, self.att_channels
        pad = -(-a // _K1_A_SLICE) * _K1_A_SLICE - a
        w1 = F.pad(self.att_w1[..., 0].float(), (0, 0, 0, pad))      # [A', 3CC]
        ab = self.att_bn
        inv = torch.rsqrt(ab.var.float() + 1e-5)
        s_bn = ab.gamma.float() * inv
        t_bn = ab.beta.float() - ab.mean.float() * s_bn
        consts = {
            "k1_w1x": w1[:, :cc].to(torch.bfloat16).contiguous(),
            "k1_w1m": w1[:, cc:2 * cc].contiguous(),
            "k1_w1s": w1[:, 2 * cc:].contiguous(),
            "k1_b1": F.pad(self.att_b1.float(), (0, pad)),
            "k1_s_bn": F.pad(s_bn, (0, pad)),
            "k1_t_bn": F.pad(t_bn, (0, pad)),
            "k1_w2": F.pad(self.att_w2[..., 0].float(), (0, pad))
            .to(torch.bfloat16).contiguous(),                       # [CC, A']
        }
        return consts

    def k1_inputs(self, x: torch.Tensor, first_f: int, hop_f: int, win_f: int,
                  n_windows: int) -> tuple:
        """The arguments :meth:`asp_head_grid_kernel` hands K1: per-window
        stats bias ``bw`` [W, A'] float32 (global-context window mean/std
        through the mean/std parts of the attention pre-projection), and the
        constants of :meth:`fold_k1` (attention width A' padded to a
        multiple of 64)."""
        mu_g, sd_g, _ = self._window_context(x, first_f, hop_f, win_f, n_windows)
        bw = mu_g @ self.k1_w1m.T + sd_g @ self.k1_w1s.T + self.k1_b1   # [W, A']
        return (x, bw, self.k1_w1x, self.k1_s_bn, self.k1_t_bn, self.k1_w2,
                self.att_b2, first_f, hop_f, win_f, n_windows)

    def asp_head_grid_kernel(self, x: torch.Tensor, first_f: int, hop_f: int,
                             win_f: int, n_windows: int) -> torch.Tensor:
        """Sliding-grid ASP through K1 (:func:`asp_grid_stats`): the JAX
        package's ``asp_head_grid_pallas``."""
        stats = asp_grid_stats(*self.k1_inputs(x, first_f, hop_f, win_f,
                                               n_windows))
        return self._stats_to_emb(stats)


def _rows_from(x: torch.Tensor, first_f: int, n_rows: int) -> torch.Tensor:
    """Time-major rows [first_f, first_f + n_rows) of x [CC, T_f], zero
    rows past the end."""
    xt = x.t()[first_f:first_f + n_rows]
    if xt.shape[0] < n_rows:
        xt = F.pad(xt, (0, 0, 0, n_rows - xt.shape[0]))
    return xt


def _asp_grid_stats_plain(x, bw, w1x, s_bn, t_bn, w2, b2, first_f: int,
                          hop_f: int, win_f: int, n_windows: int) -> torch.Tensor:
    """Plain version of K1: per-window attentive stats [W, 2*CC] float32
    (mu ++ sd), with the kernel's arithmetic: bf16 operands (features, w1x,
    the tanh activations, w2) and float32 accumulation and softmax."""
    n_rows = (n_windows - 1) * hop_f + win_f
    bf = torch.bfloat16
    xt = _rows_from(x, first_f, n_rows).to(bf).float()              # [R, CC]
    hx = xt @ w1x.to(bf).float().T                                  # [R, A]
    idx = (hop_f * torch.arange(n_windows, device=x.device)[:, None]
           + torch.arange(win_f, device=x.device)[None, :])         # [W, win]
    h = hx[idx] + bw.float()[:, None, :]
    a = torch.tanh(F.relu(h) * s_bn.float() + t_bn.float()).to(bf).float()
    e = a @ w2.to(bf).float().T + b2.float()                        # [W, win, CC]
    p = torch.softmax(e, dim=1)
    xw = xt[idx]
    mu = (p * xw).sum(1)
    m2 = (p * xw * xw).sum(1)
    sd = torch.sqrt(torch.clamp(m2 - mu * mu, min=1e-12))
    return torch.cat([mu, sd], dim=1)


# K1's geometry (csrc/asp_grid.cu): channels in tiles of 64, the attention
# width in one or two slices of 64; a window of any length is walked in
# chunks of 208 rows
_K1_CHANNEL_TILE = 64
_K1_A_SLICE = 64


def _k1_features(x: torch.Tensor, first_f: int, n_rows: int) -> torch.Tensor:
    """The feature map as K1 reads it: channel-major [CC, T_f] bf16,
    contiguous, with zero columns appended where the grid's rows
    ``[first_f, first_f + n_rows)`` run past ``T_f`` (the zero rows of
    :func:`_rows_from`).  No copy when ``x`` already is all that; the
    kernel's first launch makes the time-major copy its second one reads."""
    xb = x.to(torch.bfloat16)
    if first_f + n_rows > xb.shape[1]:
        xb = F.pad(xb, (0, first_f + n_rows - xb.shape[1]))
    return xb.contiguous()


def asp_grid_stats(x: torch.Tensor, bw: torch.Tensor, w1x: torch.Tensor,
                   s_bn: torch.Tensor, t_bn: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, first_f: int, hop_f: int, win_f: int,
                   n_windows: int) -> torch.Tensor:
    """K1: x [CC, T_f] (any float dtype), bw [W, A] float32, w1x [A, CC],
    s_bn/t_bn [A], w2 [CC, A], b2 [CC] -> [W, 2*CC] float32.  CPU tensor:
    the plain version (any A).  CUDA tensor: ``csrc/asp_grid.cu`` (two
    launches of one C entry, counted once), built for A 64 and 128 (pad a
    narrower A with zeros: :meth:`EcapaTdnn.fold_k1`), or an exception;
    the kernel has no backward, so it refuses inputs that require grad
    while autograd records (:func:`~..ops.kernels.refuse_autograd`)."""
    if True:  # the reference: the plain pooling on every device
        return _asp_grid_stats_plain(x, bw, w1x, s_bn, t_bn, w2, b2, first_f,
                                     hop_f, win_f, n_windows)
    cc = x.shape[0]
    a_dim = w1x.shape[0]
    if a_dim not in (_K1_A_SLICE, 2 * _K1_A_SLICE) or cc % _K1_CHANNEL_TILE:
        raise ValueError(
            f"asp_grid_stats kernel: attention width {a_dim} (built for 64 and "
            f"128: zero-pad a narrower one first, as EcapaTdnn.fold_k1 does) "
            f"and {cc} channels (built for multiples of {_K1_CHANNEL_TILE})")
    if win_f < 1 or n_windows < 1:
        raise ValueError(f"asp_grid_stats kernel: win_f={win_f}, "
                         f"n_windows={n_windows}")
    kernels.refuse_autograd("asp_grid_stats", x, bw, w1x, s_bn, t_bn, w2, b2)
    n_rows = (n_windows - 1) * hop_f + win_f
    dev = x.device
    xb = _k1_features(x, first_f, n_rows)
    bw = bw.float().contiguous()
    w1x_b = w1x.to(torch.bfloat16).contiguous()
    w2_b = w2.to(torch.bfloat16).contiguous()
    if w2_b.data_ptr() % 16:          # its rows are copied 16 bytes at a time
        w2_b = w2_b.clone()
    s_bn, t_bn, b2 = (v.float().contiguous() for v in (s_bn, t_bn, b2))
    for name, t, dt, shape in (("x", xb, torch.bfloat16, (cc, xb.shape[1])),
                               ("bw", bw, torch.float32, (n_windows, a_dim)),
                               ("w1x", w1x_b, torch.bfloat16, (a_dim, cc)),
                               ("s_bn", s_bn, torch.float32, (a_dim,)),
                               ("t_bn", t_bn, torch.float32, (a_dim,)),
                               ("w2", w2_b, torch.bfloat16, (cc, a_dim)),
                               ("b2", b2, torch.float32, (cc,))):
        kernels.check_cuda_tensor(t, f"asp_grid_stats: {name}", dt, shape)
    # scratch the first launch fills for the second: the grid's rows
    # time-major, and their pre-projection
    x_t = torch.empty((n_rows, cc), dtype=torch.bfloat16, device=dev)
    hx = torch.empty((n_rows, a_dim), dtype=torch.float32, device=dev)
    out = torch.empty((n_windows, 2 * cc), dtype=torch.float32, device=dev)
    # b2 shifts all of a channel's logits alike: the softmax cancels it
    kernels.launch(
        "asp_grid_stats", xb.data_ptr(), xb.shape[1], first_f, cc,
        bw.data_ptr(), w1x_b.data_ptr(), s_bn.data_ptr(), t_bn.data_ptr(),
        w2_b.data_ptr(), a_dim, hop_f, win_f, n_windows, n_rows,
        x_t.data_ptr(), hx.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, device=dev,
        shape=f"A {a_dim}, CC {cc}, win_f {win_f}, hop_f {hop_f}",
        # the net's own width: fold_k1's zero padding adds all-zero w2 columns
        work=lambda: cost.asp_grid_work(cc, int((w2 != 0).any(0).sum()), hop_f,
                                        win_f, n_windows))
    return out


class EcapaModel(nn.Module):
    """Waveform-level wrapper around :class:`EcapaTdnn` for the streaming
    grid.  ``streaming_trained`` and ``refine_sub_cos`` come from the
    checkpoint's ``__meta__`` sidecar."""

    def __init__(self, net: EcapaTdnn | None = None, sample_rate: int = 16000):
        super().__init__()
        self.net = net or EcapaTdnn()
        self.sample_rate = sample_rate
        self.streaming_trained = False
        self.refine_sub_cos: float | None = None

    def encode_batch(self, wavs: torch.Tensor) -> torch.Tensor:
        """Per-utterance embeddings of [B, T] waveforms (e.g. the windowed
        grid's windows, a strided view): :func:`~..dsp.mel.fbank_batch`
        (one K2 launch on the card), then :meth:`EcapaTdnn.embed_utterances` ->
        [B, emb_dim] float32."""
        from ..dsp.mel import fbank_batch

        feats = fbank_batch(wavs, sample_rate=self.sample_rate,
                            n_mels=self.net.n_mels)
        return self.net.embed_utterances(feats)

    def encode_grid_feats(self, feats: torch.Tensor, n_windows: int, margin: int,
                          win: int, hop: int,
                          backend: str | None = None) -> torch.Tensor:
        """Streaming sliding-window embeddings from the chunk's log-mel
        ``feats`` [T_f, n_mels]: sliding fbank mean-norm, ONE trunk pass with
        sliding SE, then per-window ASP -> [n_windows, emb_dim].  A batch of
        chunks [B, T_f, n_mels] (the training recipes' utterances) is one
        trunk pass over B rows -> [B, n_windows, emb_dim] (the plain head
        only).  Window ``i``
        pools trunk frames from ``(margin + i*hop) / mel_hop``.

        ``backend`` (the JAX argument): 'kernel' pools through K1, which
        has no backward and takes one chunk; 'decomposed' through the plain
        differentiable head, which training must name; None or 'auto' is
        the kernel on a CUDA tensor (a batch: one K1 launch a row, after the
        one trunk pass) and the plain head on the CPU."""
        per_row = backend in (None, "auto") and feats.ndim == 3
        if backend in (None, "auto"):
            backend = "decomposed"  # the reference: the net's own dtype
        if backend not in ("kernel", "decomposed"):
            raise ValueError(f"unknown ASP backend {backend!r}")
        if backend == "kernel" and feats.ndim != 2 and not per_row:
            raise ValueError("the K1 head pools one chunk; a batch of chunks "
                             "takes backend='decomposed' or 'auto'")
        mel_hop = int(self.sample_rate * 10 // 1000)
        if margin % hop or hop % mel_hop or win % mel_hop:
            raise ValueError("grid geometry must align to the 10 ms mel hop")
        win_f = win // mel_hop + 1          # frames per window (center=True)
        hop_f = hop // mel_hop
        f = (feats[None] if feats.ndim == 2 else feats).float()    # [B, T_f, M]
        f = f - sliding_mean_time(f.transpose(1, 2), win_f).transpose(1, 2)
        x = self.net.trunk(f, se_win=win_f)                         # [B, CC, T_f]
        first = margin // mel_hop
        need_f = first + (n_windows - 1) * hop_f + win_f
        if x.shape[-1] < need_f:
            x = F.pad(x, (0, need_f - x.shape[-1]))
        if backend == "kernel":
            out = [self.net.asp_head_grid_kernel(xb, first, hop_f, win_f,
                                                 n_windows) for xb in x]
            return out[0] if feats.ndim == 2 else torch.stack(out)
        out = self.net.asp_head_grid(x, first, hop_f, win_f, n_windows)
        return out[0] if feats.ndim == 2 else out

    def encode_grid_chunk(self, y: torch.Tensor, n_windows: int, margin: int,
                          win: int, hop: int,
                          backend: str | None = None) -> torch.Tensor:
        """[T_chunk] waveform slice incl. margins -> [n_windows, emb_dim];
        a batch [B, T] is one log-mel launch and one trunk pass ->
        [B, n_windows, emb_dim] (``backend``: :meth:`encode_grid_feats`)."""
        from ..dsp.mel import fused_log_mel

        feats = fused_log_mel(y, sample_rate=self.sample_rate,
                              n_mels=self.net.n_mels)
        return self.encode_grid_feats(feats, n_windows, margin, win, hop,
                                      backend=backend)
