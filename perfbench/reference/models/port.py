"""Weights carried across: flat numpy arrays + architecture meta -> module.

The checkpoint format is the JAX package's flat npz (``'/'``-separated keys,
floats possibly stored as float16, architecture in the ``__meta__`` JSON
sidecar).  :func:`params_from_numpy` also takes a JAX params pytree
flattened to numpy the same way, so any JAX-initialised net can be carried
across.  Float16 arrays are upcast to float32; the compute dtype is a
property of the net, not of the stored weights.  Torch checkpoint files (a
3D-Speaker export, the GTCRN DNS3 tar, a ModelScope bundle, a demucs
package) are read by :func:`read_torch_file` with ``weights_only=True``.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from .ecapa import EcapaModel, EcapaTdnn
from .gtcrn import GTCRN
from .segmentation import SegmentationModel, SegNet
from .vad import VadConvNet, VadModel, VadNet

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, torch.float32: torch.float32,
           torch.bfloat16: torch.bfloat16}


def load_params_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Flat arrays of a checkpoint, float16 upcast to float32."""
    out = {}
    with np.load(str(path)) as data:
        for k in data.files:
            if k == "__meta__":
                continue
            a = data[k]
            out[k] = a.astype(np.float32) if a.dtype == np.float16 else a
    return out


def load_params_meta(path: str | Path) -> dict:
    """The ``__meta__`` sidecar of a checkpoint ({} when absent)."""
    with np.load(str(path)) as data:
        if "__meta__" not in data.files:
            return {}
        return json.loads(bytes(data["__meta__"]).decode())


# the GRU VAD's JAX ``GRUParams`` -> torch ``nn.GRU`` names (same packing:
# rows (r, z, n))
_GRU_KEYS = {"gru.w_ih": "gru.weight_ih_l0", "gru.w_hh": "gru.weight_hh_l0",
             "gru.b_ih": "gru.bias_ih_l0", "gru.b_hh": "gru.bias_hh_l0"}


# the segmentation net's BiGRU pairs: 'gru{i}_f/w_ih' -> 'gru{i}.weight_ih_l0',
# 'gru{i}_b/b_hh' -> 'gru{i}.bias_hh_l0_reverse' (one bidirectional nn.GRU)
_SEG_GRU = re.compile(r"^gru(\d+)_([fb])/([wb])_(ih|hh)$")


def _state_key(flat_key: str) -> str:
    # 'block0/conv1/w' -> 'block.0.conv1.w'; 'res2/1/b' -> 'res2.1.b'
    m = _SEG_GRU.match(flat_key)
    if m:
        return (f"gru{m[1]}.{'weight' if m[3] == 'w' else 'bias'}_{m[4]}_l0"
                + ("_reverse" if m[2] == "b" else ""))
    return re.sub(r"^block(\d+)/", r"block.\1/", flat_key).replace("/", ".")


# and back: a net's state_dict key -> the JAX package's flat key
_GRU_FLAT = {v: k for k, v in _GRU_KEYS.items()}
_SEG_GRU_STATE = re.compile(r"^gru(\d+)\.(weight|bias)_(ih|hh)_l0(_reverse)?$")
# nets whose JAX parameter dict is already keyed by the state_dict names
DOTTED_NETS = (GTCRN,)


def flat_key(state_key: str, dotted: bool = False) -> str:
    """The JAX flat key of a ``state_dict`` key (the inverse of the mapping
    :func:`params_from_numpy` applies): 'block.0.conv1.w' ->
    'block0/conv1/w', 'gru.weight_ih_l0' -> 'gru/w_ih',
    'gru2.bias_hh_l0_reverse' -> 'gru2_b/b_hh'.  ``dotted``: the net's
    JAX keys are its state_dict keys (GTCRN, ZipEnhancer, the demixer)."""
    if dotted:
        return state_key
    m = _SEG_GRU_STATE.match(state_key)
    if m:
        return f"gru{m[1]}_{'b' if m[4] else 'f'}/{m[2][0]}_{m[3]}"
    k = _GRU_FLAT.get(state_key, state_key)
    return re.sub(r"^block\.(\d+)\.", r"block\1.", k).replace(".", "/")


def flat_params(net: torch.nn.Module) -> dict[str, np.ndarray]:
    """A net's weights as the JAX package's flat dict of float32 arrays:
    the format of :func:`save_params_npz`, loadable in both packages."""
    dotted = isinstance(net, DOTTED_NETS)
    return {flat_key(k, dotted): v.detach().float().cpu().numpy()
            for k, v in net.state_dict().items()}


def save_params_npz(params: dict, path: str | Path,
                    meta: dict | None = None, store_dtype=None) -> None:
    """The JAX package's checkpoint format: flat npz, the architecture (any
    JSON-able dict) under the reserved ``__meta__`` key as UTF-8 bytes.
    ``store_dtype`` (e.g. ``np.float16``, half the size of shipped weights)
    is the stored type of every floating array; :func:`load_params_npz`
    upcasts float16 back to float32."""
    arrays = {}
    for k, v in params.items():
        a = np.asarray(v)
        if store_dtype is not None and np.issubdtype(a.dtype, np.floating):
            a = a.astype(store_dtype)
        arrays[k] = a
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    np.savez(str(path), **arrays)


def update_params_meta(path: str | Path, **updates) -> dict:
    """Merge ``updates`` into a checkpoint's ``__meta__`` sidecar in place
    (e.g. a calibrated ``refine_sub_cos``); the arrays are kept as stored
    (float16 stays float16).  Returns the merged meta."""
    with np.load(str(path)) as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    meta = load_params_meta(path) | updates
    save_params_npz(arrays, path, meta=meta)
    return meta


def params_from_numpy(flat: dict[str, np.ndarray], arch_meta: dict,
                      kind: str | None = None, dtype=None) -> torch.nn.Module:
    """Rebuild a net from its architecture meta and load ``flat`` into it.

    ``kind``: 'vad' (the conv TCN when ``arch_meta['arch'] == 'conv'``,
    else the GRU net at its default widths), 'ecapa' or
    'segmentation' (the overlap detector; its net meta names
    ``n_speakers``); inferred from the meta when None.  ``dtype`` is the ECAPA compute dtype
    (weights stay float32).  Every parameter of the net must be present and
    every array must be used (the classifier head of a training checkpoint
    is dropped), or this raises."""
    net_cfg = dict(arch_meta.get("net", {}))
    if kind is None:
        kind = ("vad" if arch_meta.get("arch") == "conv"
                else "segmentation" if "n_speakers" in net_cfg else "ecapa")
    if "dilations" in net_cfg:
        net_cfg["dilations"] = tuple(net_cfg["dilations"])
    if kind == "vad":
        # the JAX loader's rule: 'conv' in the meta is the TCN at the meta's
        # widths; anything else is the GRU net at its defaults
        if arch_meta.get("arch") == "conv":
            model = VadModel(VadConvNet(**net_cfg))
        else:
            model = VadModel(VadNet())
        net = model.net
    elif kind == "ecapa":
        net = EcapaTdnn(**net_cfg, dtype=_DTYPES[dtype])
        model = EcapaModel(net)
        model.streaming_trained = bool(arch_meta.get("streaming_stats", False))
        rsc = arch_meta.get("refine_sub_cos")
        model.refine_sub_cos = float(rsc) if rsc is not None else None
    elif kind == "segmentation":
        # a checkpoint without meta is the recurrent 96/96 sigmoid-head net
        # (SegNet's defaults), as the JAX loader reads it
        net = SegNet(**net_cfg)
        model = SegmentationModel(net)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    state = {}
    for k, v in flat.items():
        if k == "classifier" or k.startswith("classifier/"):
            continue
        a = np.asarray(v)
        if a.dtype == np.float16:
            a = a.astype(np.float32)
        state[_GRU_KEYS.get(_state_key(k), _state_key(k))] = torch.from_numpy(
            np.array(a))
    net.load_state_dict(state, strict=True)
    return model


def load_vad(path: str | Path) -> VadModel:
    """Shipped VAD checkpoint -> :class:`VadModel`: the conv TCN when the
    ``__meta__`` says ``arch: conv``, else the GRU net (the shipped
    ``vad_synthetic.npz`` has no meta)."""
    return params_from_numpy(load_params_npz(path), load_params_meta(path),
                             kind="vad")


def load_speaker_encoder(path: str | Path, dtype=None) -> EcapaModel:
    """Shipped speaker-encoder checkpoint -> :class:`EcapaModel`; ``dtype``
    (None = float32, or torch.bfloat16) is the trunk's compute dtype."""
    return params_from_numpy(load_params_npz(path), load_params_meta(path),
                             kind="ecapa", dtype=dtype)


def load_segmentation(path: str | Path) -> SegmentationModel:
    """Shipped segmentation checkpoint -> :class:`SegmentationModel`; the
    head type and the widths travel in the ``__meta__`` sidecar (none: the
    96/96 sigmoid-head BiGRU net)."""
    return params_from_numpy(load_params_npz(path), load_params_meta(path),
                             kind="segmentation")


def _load_flat(net: torch.nn.Module, source: str | Path | dict) -> torch.nn.Module:
    """Load a checkpoint path or a flat dict of arrays (a JAX params dict
    converted to numpy loads as it is) whose keys are ``net``'s
    ``state_dict`` keys: float16 is upcast to float32, and every key must
    be present and used."""
    flat = load_params_npz(source) if isinstance(source, (str, Path)) else source
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in flat.items()}, strict=True)
    return net.eval()


def load_gtcrn(source: str | Path | dict) -> GTCRN:
    """GTCRN (the DNS3 architecture) from a checkpoint or a flat dict."""
    return _load_flat(GTCRN(), source)


def read_torch_file(path: str | Path):
    """A torch checkpoint file, read with ``weights_only=True``: tensors,
    containers and plain values only, never arbitrary pickled objects.  A
    file that pickles a class (a release demucs ``.th`` stores
    ``demucs.htdemucs.HTDemucs`` under ``klass``) needs that class's package
    to unpickle, in this package as in the JAX one; when the package is not
    installed the refusal is a ``ModuleNotFoundError`` that names it
    (ROADMAP F17)."""
    import importlib.util
    import pickle

    try:
        return torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        m = re.search(r"GLOBAL ([\w.]+)", str(e))
        top = m[1].split(".")[0] if m else None
        if top is None or importlib.util.find_spec(top) is not None:
            raise
        raise ModuleNotFoundError(
            f"{path}: the checkpoint pickles {m[1]}, and reading it needs the "
            f"{top!r} package, which is not installed (as in the JAX package); "
            "a checkpoint of tensors and plain values (for demucs: "
            "{'kwargs': ..., 'state': ...}) reads without it", name=top) from e


def torch_checkpoint(path: str | Path) -> dict:
    """A torch checkpoint file's state_dict (:func:`read_torch_file`): a
    bare one, or the one under ``state_dict``."""
    ckpt = read_torch_file(path)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def float32_arrays(src) -> dict[str, np.ndarray]:
    """A mapping of tensors or arrays as float32 numpy arrays, without the
    BatchNorm ``num_batches_tracked`` counters."""
    out = {}
    for k, v in src.items():
        if k.endswith("num_batches_tracked"):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.array(v, dtype=np.float32)
    return out


#: the JAX package's name for a torch state_dict carried across as a flat
#: dict of float32 arrays
port_torch_state_dict = float32_arrays


def load_gtcrn_checkpoint(path: str | Path) -> GTCRN:
    """The GTCRN DNS3 checkpoint (a torch tar with a ``model`` entry, or a
    bare state_dict) as a loaded :class:`GTCRN`."""
    ckpt = read_torch_file(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return _load_flat(GTCRN(), port_torch_state_dict(sd))


def check_schema(sd: dict, manifest: dict[str, tuple[int, ...]]) -> None:
    """Raise ``ValueError`` unless ``sd`` has exactly the manifest's keys,
    each at its shape (the JAX loaders' messages)."""
    missing = sorted(set(manifest) - set(sd))
    extra = sorted(set(sd) - set(manifest))
    if missing or extra:
        raise ValueError(
            f"state_dict schema mismatch: missing={missing[:5]} "
            f"({len(missing)} total), unexpected={extra[:5]} ({len(extra)} total)")
    for k, shape in manifest.items():
        if tuple(sd[k].shape) != tuple(shape):
            raise ValueError(f"{k}: expected {tuple(shape)}, got "
                             f"{tuple(sd[k].shape)}")


def load_torch_layout(net: torch.nn.Module, src,
                      strict: bool = True) -> torch.nn.Module:
    """Load a checkpoint whose keys are ``net``'s ``state_dict`` keys (a
    3D-Speaker export): ``src`` is a mapping of arrays or tensors, a
    ``.onnx`` path (its initializers) or a torch checkpoint path.
    ``strict``: the keys and shapes must equal ``net.manifest()``
    (:func:`check_schema`)."""
    if isinstance(src, (str, Path)):
        path = Path(src)
        if path.suffix == ".onnx":
            from .eres2netv2 import onnx_initializers

            src = onnx_initializers(path)
        else:
            src = torch_checkpoint(path)
    sd = float32_arrays(src)
    if strict:
        check_schema(sd, net.manifest())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=strict)
    return net.eval()
