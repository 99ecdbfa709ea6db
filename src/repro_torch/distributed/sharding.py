"""Sharding rules: DP / TP / EP (+ ZeRO-2D optimizer states) for every arch.

Counterpart of ``repro/distributed/sharding.py``, over the port's state
dicts and caches. Rules are path-pattern based and degrade gracefully: a
dimension is sharded over an axis only when divisible, otherwise it stays
replicated (whisper's 12 heads on a 16-way model axis, grok's 8 experts,
batch-1 long-context decode...).

Layout summary:
  params    — TP over "model" (heads / d_ff / experts / vocab / ssm-heads)
  optimizer — params' TP spec + ZeRO over the data axes on a free dim
  batch     — DP over ("pod","data") (baseline) or ("data",) (tier mode)
  KV caches — batch over data when divisible, else *sequence* over data
              (the 500k single-sequence decode shards its cache this way)

A ``Spec`` names, for each tensor dim, a mesh axis, a tuple of axes or None;
``placements(spec, mesh)`` turns it into DTensor placements, one a mesh dim:
``Shard(d)`` on each mesh axis that dim d is sharded over (both, for a dim
over ("pod", "data"), pod major as in JAX), ``Replicate()`` elsewhere.

The JAX trees stack each block's leaves on a leading block axis; the port
keeps one tensor a block. A port tensor's spec is the JAX leaf's with the
block axis dropped: every rule names a dim from the end, and ZeRO's search
for a free dim, from the last, meets the block axis last. Where ZeRO finds
no other free dim the JAX leaf takes the data axes on its block axis; on the
production meshes that happens to mamba2-1.3b's ``A_log``, ``D`` and
``dt_bias`` alone (48 blocks over 16 data ranks on ``SINGLE_POD``), and the
port keeps those replicated over the data axes. Cache specs identify leaves
by their ``KVCache`` and ``MambaCache`` fields.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple, Union

from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.config import MeshSpec, ModelConfig, ShapeConfig
from repro_torch.optim.adamw import jax_path

Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A partition spec: one ``Axis`` per tensor dim (fewer dims replicate
    the rest), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *dims: Axis):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"

    def padded(self, ndim: int) -> Tuple[Axis, ...]:
        return tuple(self) + (None,) * (ndim - len(self))

    def axes(self, dim: int) -> Tuple[str, ...]:
        a = self[dim] if dim < len(self) else None
        return () if a is None else (a,) if isinstance(a, str) else tuple(a)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d in range(len(spec)):
        for a in spec.axes(d):
            if a not in names:
                raise ValueError(f"{spec} names axis {a!r}, not in the mesh's {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_size(spec: Spec, dim: int, ms: MeshSpec) -> int:
    """How many shards ``spec`` splits tensor dim ``dim`` into on ``ms``."""
    n = 1
    for a in spec.axes(dim):
        n *= ms.axis_size(a)
    return n


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


class Sharder:
    def __init__(self, mesh_spec: MeshSpec):
        self.ms = mesh_spec
        self.model_size = mesh_spec.axis_size("model") if "model" in mesh_spec.axes else 1
        self.data_axes = mesh_spec.data_axes
        self.data_size = 1
        for a in self.data_axes:
            self.data_size *= mesh_spec.axis_size(a)

    # -- single-dim TP spec with graceful fallback ---------------------------
    def tp(self, shape: Tuple[int, ...], dim: int) -> Spec:
        dim = dim % len(shape)
        if _div(shape[dim], self.model_size):
            spec = [None] * len(shape)
            spec[dim] = "model"
            return Spec(*spec)
        return Spec()

    def tp_either(self, shape, dim_a: int, dim_b: int) -> Spec:
        """Prefer dim_a (e.g. experts); fall back to dim_b (e.g. d_ff)."""
        dim_a, dim_b = dim_a % len(shape), dim_b % len(shape)
        if _div(shape[dim_a], self.model_size):
            return self.tp(shape, dim_a)
        return self.tp(shape, dim_b)

    # -- add ZeRO data-axis sharding to an optimizer-state spec --------------
    def zero(self, shape: Tuple[int, ...], tp_spec: Spec) -> Spec:
        spec = list(tp_spec) + [None] * (len(shape) - len(tp_spec))
        for d in range(len(shape) - 1, -1, -1):
            if spec[d] is None and _div(shape[d], self.data_size):
                spec[d] = self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
                break
        return Spec(*spec)

    def dp(self, batch: int) -> Axis:
        """Axis (or axes) to shard a batch dim over, or None."""
        if _div(batch, self.data_size):
            return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
        if len(self.data_axes) > 1:
            sz = self.ms.axis_size("data")
            if _div(batch, sz):
                return "data"
        return None


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
_RULES = [
    # (path suffix pattern, which dim to TP-shard; None = replicate)
    ("embed", -2), ("unembed", -2), ("embed_tied", -2), ("dec_embed", -2),
    ("dec_pos", None),
    ("attn/wq", -2), ("attn/wk", -2), ("attn/wv", -2), ("attn/wo", -3),
    ("attn/bq", -2), ("attn/bk", -2), ("attn/bv", -2),
    ("self_attn/wq", -2), ("self_attn/wk", -2), ("self_attn/wv", -2), ("self_attn/wo", -3),
    ("cross_attn/wq", -2), ("cross_attn/wk", -2), ("cross_attn/wv", -2), ("cross_attn/wo", -3),
    ("mlp/w_gate", -1), ("mlp/w_up", -1), ("mlp/w_down", -2),
    ("moe/router", None),
    ("mamba/w_z", -2), ("mamba/w_x", -2), ("mamba/w_B", None), ("mamba/w_C", None),
    ("mamba/w_dt", -1),
    ("mamba/conv_x", -2), ("mamba/conv_x_b", -2),
    ("mamba/conv_B", None), ("mamba/conv_B_b", None),
    ("mamba/conv_C", None), ("mamba/conv_C_b", None),
    ("mamba/A_log", -1), ("mamba/D", -1), ("mamba/dt_bias", -1),
    ("mamba/norm_scale", -2), ("mamba/w_out", -3),
]

_MOE_RULES = [("moe/w_gate", (-3, -1)), ("moe/w_up", (-3, -1)), ("moe/w_down", (-3, -2))]


def param_spec(path: str, shape: Tuple[int, ...], sh: Sharder) -> Spec:
    """The TP spec of the tensor at JAX tree path ``path`` (``jax_path``)."""
    for pat, dims in _MOE_RULES:
        if path.endswith(pat) or (pat in path):
            return sh.tp_either(shape, *dims)
    for pat, dim in _RULES:
        if path.endswith(pat) or (pat + "/" in path) or (pat in path):
            if dim is None:
                return Spec()
            return sh.tp(shape, dim)
    return Spec()  # norms, biases, scalars


def _shapes(params) -> Mapping[str, Tuple[int, ...]]:
    """{state_dict name: shape} of a module's parameters or of a mapping of
    tensors (or shapes)."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {k: tuple(getattr(v, "shape", v)) for k, v in items}


def param_pspecs(params, mesh_spec: MeshSpec, fsdp: bool = True) -> dict:
    """{name: Spec} of a module's parameters (or a name -> tensor mapping).
    TP specs; with ``fsdp`` (default) also sharded over the data axes on a
    free dim (FSDP/ZeRO-3: DTensor gathers a block's weights where an op
    needs them whole). Pure TP (fsdp=False) trades memory for fewer
    collectives."""
    sh = Sharder(mesh_spec)
    out = {}
    for name, shape in _shapes(params).items():
        tp = param_spec(jax_path(name)[0], shape, sh)
        out[name] = sh.zero(shape, tp) if fsdp else tp
    return out


def opt_state_pspecs(params, mesh_spec: MeshSpec) -> dict:
    """ZeRO-2D: TP spec + data-axis sharding on a free dimension."""
    sh = Sharder(mesh_spec)
    return {name: sh.zero(shape, param_spec(jax_path(name)[0], shape, sh))
            for name, shape in _shapes(params).items()}


# ---------------------------------------------------------------------------
# Batch / activation / cache specs
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh_spec: MeshSpec) -> dict:
    sh = Sharder(mesh_spec)
    dp = sh.dp(shape.global_batch)
    tok = Spec(dp) if dp else Spec()
    emb = Spec(dp, None, None) if dp else Spec()
    out = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        out["patches"] = emb
    if cfg.family == "encdec":
        out = {"frames": emb, "tokens": tok, "labels": tok}
    return out


def act_pspec(cfg: ModelConfig, batch: int, mesh_spec: MeshSpec) -> Spec:
    sh = Sharder(mesh_spec)
    dp = sh.dp(batch)
    return Spec(dp, None, None) if dp else Spec()


def logits_pspec(cfg: ModelConfig, batch: int, mesh_spec: MeshSpec) -> Spec:
    sh = Sharder(mesh_spec)
    dp = sh.dp(batch)
    v = "model" if _div(cfg.padded_vocab, sh.model_size) else None
    return Spec(dp, None, v)


def _kv_spec(shp: Tuple[int, ...], dp: Axis, sh: Sharder) -> Spec:
    """(B, S, Hkv, hd): batch over data when divisible, else the sequence;
    heads over model, else (GQA: fewer KV heads than the model axis) the
    flash-decode layout, the sequence over the model axis too."""
    spec = [dp, None, None, None]
    seq_axes = []
    if not dp and _div(shp[1], sh.data_size):
        seq_axes.extend(sh.data_axes)
    if _div(shp[2], sh.model_size):
        spec[2] = "model"
    else:
        seq_size = 1
        for a in seq_axes:
            seq_size *= sh.ms.axis_size(a)
        if _div(shp[1] // max(seq_size, 1), sh.model_size):
            seq_axes.append("model")
    if seq_axes:
        spec[1] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
    return Spec(*spec)


def _mamba_spec(c, dp: Axis, sh: Sharder):
    from repro_torch.models.ssm import MambaCache

    def spec(x, heads_dim: Optional[int]):
        s = [dp] + [None] * (x.dim() - 1)
        if heads_dim is not None and _div(x.shape[heads_dim], sh.model_size):
            s[heads_dim] = "model"
        return Spec(*s)

    return MambaCache(conv_x=spec(c.conv_x, 2), conv_B=spec(c.conv_B, None),
                      conv_C=spec(c.conv_C, None), ssm=spec(c.ssm, 1))


def cache_pspecs(cache, cfg: ModelConfig, batch: int, mesh_spec: MeshSpec) -> Any:
    """Specs of a decode cache, in its structure: an LM's list of
    ``{"sub{j}": KVCache | MambaCache}`` a block, or the encoder-decoder's
    ``{"self": [KVCache], "cross": [KVCache]}``. KV: ``_kv_spec``; mamba:
    batch over data, heads over model (conv_x and the f32 state)."""
    from repro_torch.models.layers import KVCache
    from repro_torch.models.ssm import MambaCache

    sh = Sharder(mesh_spec)
    dp = sh.dp(batch)

    def f(c):
        if isinstance(c, KVCache):
            return KVCache(k=_kv_spec(tuple(c.k.shape), dp, sh),
                           v=_kv_spec(tuple(c.v.shape), dp, sh))
        if isinstance(c, MambaCache):
            return _mamba_spec(c, dp, sh)
        if isinstance(c, Mapping):
            return {k: f(v) for k, v in c.items()}
        if isinstance(c, (list, tuple)):
            return type(c)(f(v) for v in c)
        raise TypeError(f"not a cache leaf: {type(c).__name__}")

    return f(cache)
