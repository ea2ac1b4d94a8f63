"""Sharding rules: parameter paths -> partition specs over the mesh, and the
sharded train state (the port of the JAX package's `parallel/sharding.py`).

The rules are the JAX package's table, matched on the JAX path of each of
the port's parameters (`jax_path`, the inverse of `bridge.py`'s name map),
so that `param_specs` gives the JAX package's (path, spec) table for the
same model. A spec is a tuple over the JAX layout's dimensions (a Linear
kernel is (in, out)); () replicates. Megatron's split:

- attention q/k/v, FFN fc1, the conv module's pw1 and the transformer
  decoder's wq/wk/wv: column-parallel (the output features);
- attention o, fc2, pw2 and the decoder's wo: row-parallel (the input
  features), one all-reduce (or reduce-scatter under sequence
  parallelism) after each;
- everything else replicated; biases too, as in the JAX table: a
  column-parallel linear adds its bias's slice of this rank's features.

Two deliberate differences from the JAX layout:

- The LSTM weights `w_ih`/`w_hh` stay whole on every rank (the JAX rules
  split their 4H gate columns). The recurrence kernel (#11) needs all of
  W_hh and h at every step; split gates would cost an all-gather at each of
  ~800 time steps, for the same result.
- `pw1` is split as matching halves of its two GLU inputs, rank r holding
  rows [a_r; b_r] of (a; b): `F.glu` pairs feature c with c + D, so a
  contiguous split would hand rank 0 only the "a" half. The spec is the
  JAX one (the same dimension is split); only which rows differs.

Each rank keeps only its slices of the sharded parameters and of their Adam
moments (`shard_model`, `shard_tensor`); `full_tensor` gathers them back
(through host tensors) for checkpoints, export and decoding.

Under pipeline parallelism (`model.pp_stages > 1`) every parameter is
replicated, as the JAX Solver's `tp_rules=False`: the 'model' group holds
the pipeline's stages, each rank running its stage's blocks whole
(`parallel/pp.py`). Under context parallelism (`model.cp_mode`) the TP
rules stay, as in the JAX package, and the 'model' group carries both
splits: the linears by heads (q/k/v column-parallel, o row-parallel, as
above) and the attention between them by time. `MhsaBlock` gathers the
heads' columns of q, k and v, runs `parallel/cp.py` on the whole heads
with each rank holding a time slice, and hands each rank its heads'
columns of the result for `o`; the relative bias enters as the diagonals
of every head. The loss and gradients are the unsharded model's.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from pytorch_end2end_speech_recognition_tpu_torch.parallel.collectives import (
    all_gather_host,
)
from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    refuse_e_branchformer,
)

# (JAX path regex, spec); first match wins. Paths look like
# 'encoder/layers/0/fwd/w_ih' or 'encoder/blocks/3/mhsa/q/kernel'.
RULES: list[tuple[str, tuple]] = [
    (r".*/(w_ih|w_hh)$", (None, MODEL_AXIS)),          # LSTM gates
    (r".*/(fc1|q|k|v|pw1|wq1|wk1|wv1|wq2|wk2|wv2)/kernel$",
     (None, MODEL_AXIS)),
    (r".*/(fc2|o|pw2|wo1|wo2)/kernel$", (MODEL_AXIS, None)),
    (r".*/embed/embedding$", (None, None)),
    (r".*", ()),                                        # replicate
]
WHOLE = r".*/(w_ih|w_hh)$"   # the port keeps these whole (see above)
# the linears that the port's tensor-parallel modules split
TP_LINEARS = (r".*/(fc1|q|k|v|pw1|wq1|wk1|wv1|wq2|wk2|wv2|fc2|o|pw2|wo1|wo2)"
              r"/kernel$")
GLU = r".*/pw1/kernel$"      # split as GLU halves (see above)


def jax_path(name: str, owner: nn.Module) -> str:
    """The JAX package's path of the port's parameter `name` (dotted),
    owned by module `owner`: Linear and Conv weights are `kernel`,
    LayerNorm weights `scale`, Embedding weights `embedding`."""
    parent, _, leaf = name.rpartition(".")
    if leaf == "weight":
        if isinstance(owner, nn.LayerNorm):
            leaf = "scale"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "kernel"
    return "/".join(filter(None, parent.split("."))) + "/" + leaf


def spec_for(path: str, ndim: int) -> tuple:
    for pat, spec in RULES:
        if re.fullmatch(pat, path):
            return () if len(spec) > ndim else spec
    return ()


def _divisible_or_replicated(mesh, shape, spec: tuple) -> tuple:
    """Drop axis assignments whose dimension the axis size does not divide
    (the JAX rule: () when none is left)."""
    out, changed = [], False
    for d, axis in enumerate(spec):
        if axis is None:
            out.append(None)
        elif d < len(shape) and shape[d] % mesh.shape[axis] == 0:
            out.append(axis)
        else:
            out.append(None)
            changed = True
    return tuple(out) if not changed or any(out) else ()


def _jax_shape(p: torch.Tensor, path: str) -> tuple:
    """p's shape in the JAX layout (`bridge.py`'s transposes undone)."""
    s = tuple(p.shape)
    if not path.endswith("/kernel"):
        return s
    return (s[2:] + s[1:2] + s[:1]) if len(s) == 4 else s[::-1]


def _owners(model: nn.Module) -> dict:
    return {f"{mn}.{pn}" if mn else pn: mod
            for mn, mod in model.named_modules()
            for pn, _ in mod.named_parameters(recurse=False)}


def jax_specs(mesh, model: nn.Module) -> list[tuple[str, tuple]]:
    """(JAX path, spec) of every parameter by the JAX rules alone, in the
    port's parameter order: the JAX package's `param_specs` table."""
    owners = _owners(model)
    out = []
    for name, p in model.named_parameters():
        path = jax_path(name, owners[name])
        shape = _jax_shape(p, path)
        out.append((path, _divisible_or_replicated(
            mesh, shape, spec_for(path, len(shape)))))
    return out


def param_specs(mesh, model: nn.Module) -> list[tuple[str, tuple]]:
    """`jax_specs` with the port's layout: the LSTM weights replicated."""
    return [(path, () if re.fullmatch(WHOLE, path) else spec)
            for path, spec in jax_specs(mesh, model)]


def shard_dims(mesh, model: nn.Module) -> dict[str, tuple[int, bool]]:
    """{port name: (dimension of the port's tensor split over 'model',
    split as GLU halves)} for every sharded parameter."""
    out = {}
    if mesh.tp == 1:
        return out
    names = [n for n, _ in model.named_parameters()]
    for name, (path, spec) in zip(names, param_specs(mesh, model)):
        if MODEL_AXIS in spec:
            d = spec.index(MODEL_AXIS)
            out[name] = (len(spec) - 1 - d, bool(re.fullmatch(GLU, path)))
    return out


def shard_tensor(full: torch.Tensor, dim: int, glu: bool, n: int,
                 r: int) -> torch.Tensor:
    """Rank r's slice of `full` split n ways along `dim` (GLU: the matching
    slices of both halves, concatenated)."""
    if n == 1:
        return full
    if glu:
        a, b = full.chunk(2, dim)
        return torch.cat([a.chunk(n, dim)[r], b.chunk(n, dim)[r]], dim)
    return full.chunk(n, dim)[r]


def unshard_tensor(parts: list[torch.Tensor], dim: int,
                   glu: bool) -> torch.Tensor:
    """The inverse of `shard_tensor` over every rank's slice, in order."""
    if len(parts) == 1:
        return parts[0]
    if glu:
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([torch.cat([h[0] for h in halves], dim),
                          torch.cat([h[1] for h in halves], dim)], dim)
    return torch.cat(parts, dim)


def full_tensor(mesh: Mesh | None, t: torch.Tensor,
                how: tuple[int, bool] | None) -> torch.Tensor:
    """The whole of a parameter-shaped tensor on the host: its 'model'
    group's slices gathered when sharded (every rank of the group must
    call it), else `t` itself."""
    if mesh is None or how is None:
        return t.detach().cpu()
    return unshard_tensor(all_gather_host(t, mesh.model_group), *how)


def tp_rules_of(model: nn.Module) -> bool:
    """The JAX Solver's `tp_rules=cfg.model.pp_stages <= 1` for `model`
    (an `AsrModel`, whose `cfg` is an AsrConfig, or an encoder, whose `cfg`
    is a ModelConfig)."""
    return getattr(_model_cfg(model), "pp_stages", 1) <= 1


def _model_cfg(model: nn.Module):
    """The ModelConfig of an `AsrModel` (`cfg.model`) or an encoder
    (`cfg`); None for a module without one."""
    cfg = getattr(model, "cfg", None)
    return getattr(cfg, "model", cfg)


def shard_model(model: nn.Module, mesh: Mesh) -> dict:
    """Keep only this rank's slices of `model`'s sharded parameters (in
    place) and point its tensor-parallel modules at the 'model' group;
    returns `shard_dims`, kept with `param_specs` (both of the whole model)
    as `model.shard_dims` and `model.param_specs`. Raises where a
    tensor-parallel module's widths do not split tp ways (heads,
    features), and for an E-Branchformer encoder at tp > 1, which the port
    does not run. Under pipeline parallelism
    (`tp_rules_of(model)` false) every parameter stays whole and no
    module gets a group; the encoder still learns the mesh, for its
    pipeline."""
    mcfg = _model_cfg(model)
    if mesh.tp > 1 and mcfg is not None:
        refuse_e_branchformer(mcfg, f"tensor parallelism (tp={mesh.tp})")
    tp_rules = tp_rules_of(model)
    dims = shard_dims(mesh, model) if tp_rules else {}
    specs = (param_specs(mesh, model) if tp_rules else
             [(path, ()) for path, _ in param_specs(mesh, model)])
    tp_mods = [(n, m) for n, m in model.named_modules()
               if hasattr(m, "tp_group")]
    for mn, mod in tp_mods if mesh.tp > 1 and tp_rules else ():
        heads = getattr(mod, "heads", None)
        if heads and heads % mesh.tp:
            raise ValueError(f"{mn}: {heads} heads do not split over "
                             f"tp={mesh.tp}")
        for cn, child in mod.named_children():
            name = f"{mn}.{cn}.weight"
            if (isinstance(child, nn.Linear) and name not in dims
                    and re.fullmatch(TP_LINEARS, jax_path(name, child))):
                raise ValueError(f"{name} {tuple(child.weight.shape)} does "
                                 f"not split over tp={mesh.tp}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in dims:
                p.data = shard_tensor(p.data, *dims[name], mesh.tp,
                                      mesh.model_rank).contiguous()
    group = mesh.model_group if mesh.tp > 1 and tp_rules else None
    for _, mod in tp_mods:
        mod.tp_group = group
        if hasattr(mod, "set_mesh"):
            mod.set_mesh(mesh)
    model.mesh = mesh
    model.shard_dims = dims
    model.param_specs = specs
    return dims


def shard_train_state(mesh: Mesh, model: nn.Module,
                      opt_state: dict | None = None):
    """The JAX package's `shard_train_state`: shard `model` in place
    (`shard_model`, unless it is sharded already) and slice a whole
    optimizer state (`Optimizer.state_dict()`) for this rank. Returns
    (model, the sliced state or None)."""
    if getattr(model, "mesh", None) is None:
        shard_model(model, mesh)
    if opt_state is not None:
        names = [n for n, _ in model.named_parameters()]
        opt_state = shard_opt_state(opt_state, names, model.shard_dims, mesh)
    return model, opt_state


def gather_model(model: nn.Module) -> nn.Module:
    """A whole copy of a sharded or pipelined `AsrModel` on this rank's
    device, off the mesh (a collective of its 'model' group); the model
    itself when it is neither."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or (not model.shard_dims and tp_rules_of(model)):
        return model
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )

    sd = {n: full_tensor(mesh, p, model.shard_dims.get(n))
          for n, p in model.named_parameters()}
    whole = AsrModel(model.cfg, device=mesh.device)
    whole.load_state_dict(sd, strict=False)
    return whole.train(model.training)


def shard_opt_state(state: dict, names: list[str], dims: dict,
                    mesh: Mesh) -> dict:
    """A full optimizer state (`Optimizer.state_dict()`, per-parameter lists
    in `names`' order) sliced for this rank."""
    out = dict(state)
    for key in ("m1", "m2", "acc"):
        vals = state[key]
        if vals:
            out[key] = [shard_tensor(v, *dims[n], mesh.tp, mesh.model_rank)
                        if n in dims else v for n, v in zip(names, vals)]
    return out


def full_opt_state(state: dict, names: list[str], dims: dict,
                   mesh: Mesh) -> dict:
    """This rank's optimizer state with its sharded moments gathered whole
    on the host (collective over the 'model' group)."""
    out = dict(state)
    for key in ("m1", "m2", "acc"):
        out[key] = [full_tensor(mesh, v, dims.get(n))
                    for n, v in zip(names, state[key])] if state[key] else []
    return out


def sharded_mask(names: list[str], dims: dict) -> torch.Tensor:
    """Bool (P,): which parameters, in `names`' order, are sharded."""
    return torch.from_numpy(np.array([n in dims for n in names], bool))
