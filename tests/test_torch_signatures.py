"""The signature guard: every public function, class, method and
module-level name of each module that both packages have exists in the
port and takes every parameter name the JAX one takes (or ``**kwargs``),
but for the entries of ``JAX_ONLY``, each with its reason.

Both packages are parsed with ``ast``; neither is imported.  A class's
constructor names are its ``__init__``'s parameters and, for a dataclass or
a ``NamedTuple``, its fields; a port ``nn.Module`` answers a JAX
``__call__`` with ``forward``.  Methods and constructors are looked up
through the base classes that the port package defines.  A port name
bound by an import from the port package is followed to its definition.
An entry of ``JAX_ONLY`` that nothing needs any more fails, so the list
cannot go stale.  ``tests/test_torch_exports.py`` guards the subpackages'
``__all__``; this file guards the signatures behind them.
"""
from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "speech_diarization_tpu"
PORT_ROOT = ROOT / "speech_diarization_tpu_torch"

_PARAMS = "the JAX params pytree: an nn.Module holds its weights"
_INIT = "JAX's seeded init: the nn.Module's constructor makes its weights"
_APPLY = "JAX's functional forward: the nn.Module's forward"
_LAYER = "a functional JAX layer; the port writes it as an nn.Module"
_DEFER = "defer: JAX's asynchronous dispatch; torch queues on the card itself"
_JIT = "a jax.jit switch; the port runs eager"
_BUCKET = "a compile-bucket bound of XLA's static shapes"
_DTYPE = "the net's compute dtype; the port's counterpart is .to(dtype)"
_MESH = "a jax.sharding.Mesh; the port's counterpart is mesh_or_device"
_ENSEMBLE = ("the ensemble as JAX params drawn by jax.random; the port's "
             "EnsembleDemixer takes nets=")

# JAX names and parameters the port does not take, each with its reason:
# the "Not to port" list of ROADMAP.md, entry by entry
JAX_ONLY: dict[str, str] = {
    "cluster.kmeans:farthest_point_init:k_max": _BUCKET,
    "cluster.kmeans:kmeans:k_max": _BUCKET,
    "dsp.loudness:k_weight:mode": "selects dsp/iir.py's associative scan, which "
                                  "is not ported; the port's k_weight is the FIR form",
    "dsp.mel:log_mel_spectrogram:backend": "the XLA / Pallas switch; the port "
                                           "chooses by the tensor's device",
    "dsp.resample:resample_poly_jax": "its counterpart is dsp/resample.py::resample_poly",
    "dsp.stft:DEFAULT_DFT_MODE": "picks XLA's matmul or FFT lowering of the DFT "
                                 "for every call; the port's stft / istft take "
                                 "matmul= per call (None: the products)",
    "models.campp:Params": _PARAMS,
    "models.campp:CamPlusPlus.__init__:dtype": _DTYPE,
    "models.campp:CamPlusPlus.init": _INIT,
    "models.campp:CamPlusPlus.apply": _APPLY,
    "models.campp:CamPlusPlusModel.init": _INIT,
    "models.campp:CamPlusPlusModel.encode_batch:params": _PARAMS,
    "models.demix:Params": _PARAMS,
    "models.demix:DialogDemixer.init": _INIT,
    "models.demix:DialogDemixer.apply": _APPLY,
    "models.demucs_ref:Params": _PARAMS,
    "models.demucs_ref:glu": _LAYER,
    "models.demucs_ref:group_norm_1:p": _PARAMS + " (the port's takes weight, bias)",
    "models.demucs_ref:group_norm_1:prefix": _PARAMS + " (the port's takes weight, bias)",
    "models.demucs_ref:layer_norm": _LAYER,
    "models.demucs_ref:conv_transpose1d_torch": _LAYER,
    "models.demucs_ref:conv_transpose2d_freq": _LAYER,
    "models.demucs_ref:dconv": _LAYER,
    "models.demucs_ref:henc_layer": _LAYER,
    "models.demucs_ref:hdec_layer": _LAYER,
    "models.demucs_ref:multihead_attention": _LAYER,
    "models.demucs_ref:self_attention_layer": _LAYER,
    "models.demucs_ref:cross_attention_layer": _LAYER,
    "models.demucs_ref:cross_transformer": _LAYER,
    "models.demucs_ref:HTDemucsRef.init": _INIT,
    "models.demucs_ref:HTDemucsRef.apply": _APPLY,
    "models.ecapa:Params": _PARAMS,
    "models.ecapa:EcapaTdnn.init": _INIT,
    "models.ecapa:EcapaTdnn.trunk:params": _PARAMS,
    "models.ecapa:EcapaTdnn.apply": _APPLY,
    "models.ecapa:EcapaTdnn.asp_head:params": _PARAMS,
    "models.ecapa:EcapaTdnn.asp_head_grid:params": _PARAMS,
    "models.ecapa:EcapaTdnn.asp_head_grid_pallas": "the Pallas route of the grid "
                                                   "head; its counterpart is "
                                                   "asp_head_grid_kernel (K1)",
    "models.ecapa:EcapaModel.init": _INIT,
    "models.ecapa:EcapaModel.encode_batch:params": _PARAMS,
    "models.ecapa:EcapaModel.encode_grid_chunk:params": _PARAMS,
    "models.eres2netv2:Params": _PARAMS,
    "models.eres2netv2:ERes2NetV2.__init__:dtype": _DTYPE,
    "models.eres2netv2:ERes2NetV2.init": _INIT,
    "models.eres2netv2:ERes2NetV2.apply": _APPLY,
    "models.eres2netv2:ERes2NetV2Model.init": _INIT,
    "models.eres2netv2:ERes2NetV2Model.encode_batch:params": _PARAMS,
    "models.gtcrn:Params": _PARAMS,
    "models.gtcrn:erb_compress": _LAYER,
    "models.gtcrn:erb_synthesize": _LAYER,
    "models.gtcrn:tra": _LAYER,
    "models.gtcrn:conv_block": _LAYER,
    "models.gtcrn:gt_conv_block": _LAYER,
    "models.gtcrn:grnn": _LAYER,
    "models.gtcrn:dpgrnn": _LAYER,
    "models.gtcrn:GTCRN.apply": _APPLY,
    "models.gtcrn:gtcrn_init_params": _INIT,
    "models.layers:conv2d_torch": _LAYER + " (nn.Conv2d)",
    "models.layers:conv_transpose2d_torch": _LAYER + " (nn.ConvTranspose2d)",
    "models.layers:prelu": _LAYER + " (nn.PReLU)",
    "models.layers:GRUParams": "the JAX GRU's weights; nn.GRU holds them",
    "models.layers:gru_init": _INIT + " (nn.GRU)",
    "models.layers:gru_sequence": _LAYER + " (nn.GRU, cuDNN on the card)",
    "models.layers:bigru_sequence": _LAYER + " (a bidirectional nn.GRU)",
    "models.port_vad:distill_vad_from_silero:jit_path": _JIT,
    "models.registry:make_encoder:jit": _JIT,
    "models.segmentation:Params": _PARAMS,
    "models.segmentation:SegNet.init": _INIT,
    "models.segmentation:SegNet.logits:params": _PARAMS,
    "models.segmentation:SegNet.apply": _APPLY,
    "models.segmentation:SegNet.apply_hard:params": _PARAMS,
    "models.segmentation:SegmentationModel.init": _INIT,
    "models.segmentation:SegmentationModel.activities:params": _PARAMS,
    "models.segmentation:SegmentationModel.head_logits:params": _PARAMS,
    "models.segmentation:SegmentationModel.hard_activities:params": _PARAMS,
    "models.vad:Params": _PARAMS,
    "models.vad:VadNet.init": _INIT,
    "models.vad:VadNet.apply": _APPLY,
    "models.vad:VadConvNet.init": _INIT,
    "models.vad:VadConvNet.apply": _APPLY,
    "models.vad:VadModel.init": _INIT,
    "models.vad:VadModel.probs:params": _PARAMS,
    "models.zipenhancer:Params": _PARAMS,
    "models.zipenhancer:ZipEnhancerModel.init": _INIT,
    "models.zipenhancer:ZipEnhancerModel.apply": _APPLY,
    "models.zipenhancer_ref:Params": _PARAMS,
    "models.zipenhancer_ref:bias_norm": _LAYER,
    "models.zipenhancer_ref:bypass": _LAYER,
    "models.zipenhancer_ref:rel_shift": _LAYER,
    "models.zipenhancer_ref:attention_weights": _LAYER,
    "models.zipenhancer_ref:self_attention": _LAYER,
    "models.zipenhancer_ref:feed_forward": _LAYER,
    "models.zipenhancer_ref:nonlin_attention": _LAYER,
    "models.zipenhancer_ref:convolution_module": _LAYER,
    "models.zipenhancer_ref:zipformer2_layer": _LAYER,
    "models.zipenhancer_ref:downsampled_zipformer2_encoder": _LAYER,
    "models.zipenhancer_ref:prelu": _LAYER,
    "models.zipenhancer_ref:instance_norm2d": _LAYER,
    "models.zipenhancer_ref:dense_block": _LAYER,
    "models.zipenhancer_ref:sp_conv_transpose2d": _LAYER,
    "models.zipenhancer_ref:dense_encoder": _LAYER,
    "models.zipenhancer_ref:mask_decoder": _LAYER,
    "models.zipenhancer_ref:phase_decoder": _LAYER,
    "models.zipenhancer_ref:ZipEnhancerRef.init": _INIT,
    "models.zipenhancer_ref:ZipEnhancerRef.apply_spec:p": _PARAMS,
    "models.zipenhancer_ref:ZipEnhancerRef.apply": _APPLY,
    "parallel.sharding:jnp_asarray": "puts a host array on JAX devices; "
                                     "torch's .to(device) does",
    "pipelines.chunking:chunked_framewise:defer": _DEFER,
    "pipelines.demix:EnsembleDemixer.__init__:param_sets": _ENSEMBLE,
    "pipelines.demix:EnsembleDemixer.__init__:model": _ENSEMBLE,
    "pipelines.demix:EnsembleDemixer.__init__:n_models": _ENSEMBLE,
    "pipelines.diarize:DiarizationPipeline.vad_probs:defer": _DEFER,
    "pipelines.diarize:DiarizationPipeline.vad_frame_energy:defer": _DEFER,
    "pipelines.enhance:GtcrnEnhancer.__init__:params": _PARAMS + " (the port takes net=)",
    "pipelines.segmentation:make_seg_activities_fn:params": _PARAMS,
    "segment.embed:embed_windows:defer": _DEFER,
    "segment.embed:embed_windows:max_batch": _BUCKET,
    "segment.embed:embed_windows_streaming:params": _PARAMS,
    "segment.embed:embed_windows_streaming:defer": _DEFER,
    "train.checkpoint:export_inference_weights:params": _PARAMS,
    "train.steps:TrainState.__init__:opt_state": "optax's state; the port's "
                                                 "counterpart is optimizer",
    "train.steps:make_ecapa_train_step:mesh": _MESH,
    "train.steps:make_gtcrn_train_step:mesh": _MESH,
    "utils.profiling:Profiler.xla_trace": "the XLA trace; the port's counterpart is trace",
}


@lru_cache(maxsize=None)
def _module_names(root: Path) -> frozenset[str]:
    return frozenset(".".join(p.relative_to(root).with_suffix("").parts)
                     for p in root.rglob("*.py"))


COMMON = sorted(_module_names(JAX_ROOT) & _module_names(PORT_ROOT))


def _public(name: str) -> bool:
    return not name.startswith("_")


class _Module:
    """One parsed module: its top-level defs, classes, assigned names and
    imported names (the latter as ``(module, name)``, relative imports
    resolved against ``pkg``)."""

    def __init__(self, root: Path, name: str):
        path = root.joinpath(*name.split(".")).with_suffix(".py")
        if not path.exists():
            path = root.joinpath(*name.split("."), "__init__.py")
        self.tree = ast.parse(path.read_text()) if path.exists() else ast.Module(body=[])
        self.defs: dict[str, ast.AST] = {}
        self.assigned: set[str] = set()
        self.imported: dict[str, tuple[str, str]] = {}
        parts = [p for p in name.split(".") if p]
        pkg = parts if path.name == "__init__.py" and parts[-1:] != ["__init__"] else parts[:-1]
        self.root_pkg = root.name
        for node in self.tree.body:
            self._visit(node, pkg)

    def _visit(self, node, pkg):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            self.defs[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self.assigned.add(n.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                self.assigned.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join([*base, *(node.module or "").split(".")]).strip(".")
            elif (node.module or "").split(".")[0] == self.root_pkg:
                mod = node.module[len(self.root_pkg):].strip(".")
            else:
                mod = None
            for a in node.names:
                self.imported[a.asname or a.name] = (mod, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                self.imported[a.asname or a.name.split(".")[0]] = (None, a.name)
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in [*node.body, *getattr(node, "orelse", []),
                        *getattr(node, "finalbody", []),
                        *[s for h in getattr(node, "handlers", []) for s in h.body]]:
                self._visit(sub, pkg)


@lru_cache(maxsize=None)
def _mod(root: Path, name: str) -> _Module:
    return _Module(root, name)


def _resolve(root: Path, mod: _Module, name: str, depth: int = 0):
    """The port definition a name of ``mod`` stands for: a def / class
    node, ``"assigned"``, ``"external"`` (imported from outside the
    package), or None (absent)."""
    if name in mod.defs:
        return mod.defs[name]
    if name in mod.assigned:
        return "assigned"
    if name in mod.imported:
        src, orig = mod.imported[name]
        if src is None or depth > 8:
            return "external"
        target = _mod(root, src)
        found = _resolve(root, target, orig, depth + 1)
        if found is None and src + "." + orig in _module_names(root):
            return "assigned"   # a submodule
        return found
    return None


def _params(fn: ast.AST, method: bool) -> tuple[list[str], bool]:
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if method and names and not _is_static(fn):
        names = names[1:]
    return names, a.kwarg is not None


def _is_static(fn: ast.AST) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "staticmethod"
               for d in fn.decorator_list)


def _decorated(node: ast.ClassDef, name: str) -> bool:
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if (isinstance(d, ast.Name) and d.id == name) or (
                isinstance(d, ast.Attribute) and d.attr == name):
            return True
    return False


def _fields(node: ast.ClassDef) -> list[str] | None:
    """Dataclass / NamedTuple fields, or None when the class is neither."""
    named_tuple = any((isinstance(b, ast.Name) and b.id == "NamedTuple") or (
        isinstance(b, ast.Attribute) and b.attr == "NamedTuple") for b in node.bases)
    if not (_decorated(node, "dataclass") or named_tuple):
        return None
    out = []
    for st in node.body:
        if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
            ann = ast.unparse(st.annotation)
            if "ClassVar" not in ann:
                out.append(st.target.id)
    return out


class _Class:
    """A class with its bases resolved inside one package."""

    def __init__(self, root: Path, mod: _Module, node: ast.ClassDef):
        self.methods = {n.name: n for n in node.body
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.fields = _fields(node)
        self.class_names = {t.id for st in node.body if isinstance(st, ast.Assign)
                            for t in st.targets if isinstance(t, ast.Name)}
        self.bases: list[_Class] = []
        self.external_base = False
        for b in node.bases:
            bname = b.id if isinstance(b, ast.Name) else None
            found = _resolve(root, mod, bname) if bname else None
            if isinstance(found, ast.ClassDef):
                owner = _owner(root, mod, bname)
                self.bases.append(_Class(root, owner, found))
            elif not (isinstance(b, ast.Name) and b.id in ("object", "NamedTuple")):
                self.external_base = True

    def method(self, name: str):
        if name in self.methods:
            return self.methods[name]
        for b in self.bases:
            m = b.method(name)
            if m is not None:
                return m
        return None

    def has_attr(self, name: str) -> bool:
        if name in self.methods or name in self.class_names or (
                self.fields and name in self.fields):
            return True
        return any(b.has_attr(name) for b in self.bases)

    def init_names(self) -> tuple[list[str], bool] | None:
        """The constructor's parameter names and whether it takes
        ``**kwargs``; None when no class in the chain defines one."""
        init = self.methods.get("__init__")
        if init is not None:
            return _params(init, True)
        if self.fields is not None:
            inherited = [b.init_names() for b in self.bases]
            names = [n for got in inherited if got for n in got[0]]
            return names + self.fields, False
        for b in self.bases:
            got = b.init_names()
            if got is not None:
                return got
        return None


def _owner(root: Path, mod: _Module, name: str) -> _Module:
    """The module that defines ``name`` as seen from ``mod``."""
    depth = 0
    while name not in mod.defs and name in mod.imported and depth < 8:
        src, name = mod.imported[name]
        mod = _mod(root, src)
        depth += 1
    return mod


def _jax_entries(name: str):
    """(key, kind, payload) for every public surface item of a JAX module.
    kind: 'name' (module-level name), 'fn' (function params), 'init',
    'method'."""
    mod = _mod(JAX_ROOT, name)
    for n in sorted(mod.assigned):
        if _public(n) and n not in mod.defs:
            yield f"{name}:{n}", "name", n
    for n, node in mod.defs.items():
        if not _public(n):
            continue
        if isinstance(node, ast.ClassDef):
            cls = _Class(JAX_ROOT, mod, node)
            yield f"{name}:{n}", "class", (n, cls)
        else:
            yield f"{name}:{n}", "fn", (n, node)


def _check_module(name: str) -> list[str]:
    """Every missing item of module ``name`` as a ``JAX_ONLY``-style key."""
    port = _mod(PORT_ROOT, name)
    missing: list[str] = []

    def need_params(key, jax_names, port_fn):
        names, kwargs = port_fn
        if kwargs:
            return
        for p in jax_names:
            if p not in names:
                missing.append(f"{key}:{p}")

    for key, kind, payload in _jax_entries(name):
        if kind == "name":
            if _resolve(PORT_ROOT, port, payload) is None:
                missing.append(key)
            continue
        n = payload[0]
        found = _resolve(PORT_ROOT, port, n)
        if found is None:
            missing.append(key)
            continue
        if kind == "fn":
            if isinstance(found, (ast.FunctionDef, ast.AsyncFunctionDef)):
                need_params(key, _params(payload[1], False)[0],
                            _params(found, False))
            elif isinstance(found, ast.ClassDef):
                pcls = _Class(PORT_ROOT, _owner(PORT_ROOT, port, n), found)
                got = pcls.init_names()
                if got is not None:
                    need_params(key, _params(payload[1], False)[0], got)
            continue
        jcls: _Class = payload[1]
        if not isinstance(found, ast.ClassDef):
            continue       # a factory or an alias stands for the class
        pcls = _Class(PORT_ROOT, _owner(PORT_ROOT, port, n), found)
        jinit = jcls.init_names()
        if jinit is not None:
            # no constructor in the port's chain: a base from outside the
            # package (nn.Module) takes what it takes
            pinit = pcls.init_names() or ([], pcls.external_base)
            need_params(f"{key}.__init__", jinit[0], pinit)
        for mname, mnode in jcls.methods.items():
            if mname == "__init__" or not (_public(mname) or mname == "__call__"):
                continue
            mkey = f"{key}.{mname}"
            pm = pcls.method(mname)
            if pm is None and mname == "__call__":
                pm = pcls.method("forward")
            if pm is None:
                if not pcls.has_attr(mname):
                    missing.append(mkey)
                continue
            need_params(mkey, _params(mnode, True)[0], _params(pm, True))
    return missing


@pytest.mark.parametrize("module", COMMON)
def test_port_signatures_cover_the_jax_module(module):
    missing = _check_module(module)
    allowed = {k for k in JAX_ONLY if k.split(":")[0] == module}
    assert sorted(set(missing) - allowed) == [], module
    assert sorted(allowed - set(missing)) == [], f"stale JAX_ONLY entries in {module}"
    assert all(JAX_ONLY[k].strip() for k in allowed)
