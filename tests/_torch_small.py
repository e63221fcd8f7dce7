"""The small model the port's serving tests share: qwen1.5-0.5b at 2 layers,
128 wide, vocab 256, f32 (ROADMAP R2), random reference weights carried
into the port with ``convert.from_reference``.  The embedding is scaled to
0.05 so the layers, not the tied head's echo of the input token, pick the
next token."""
import os
import types

import jax
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference
from repro_torch.models.model import build_model


def share_cores() -> None:
    """Give torch's intra-op pool this process's share of the cores when
    pytest-xdist runs ``PYTEST_XDIST_WORKER_COUNT`` workers: each worker's
    pool would otherwise start a thread per core, so that the machine
    runs workers x cores busy threads, and the one-thread gloo ranks of
    the mesh tests wait out a time slice at every gather."""
    n = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if n > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n))


share_cores()

SMALL = dict(d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=4,
             vocab=256, n_layers=2, dtype="float32")


def small_models(backend="all", seed=1):
    """Reference config/API/params (dense and packed for ``backend``) and
    the port's API and the same params carried across, on the CPU."""
    cfg = ref_scale_down(REF_ARCHS["qwen1.5-0.5b"], **SMALL)
    api = ref_build_model(cfg)
    dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(seed)))
    dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
    packed = ref_convert(dense, squeeze=1, backend=backend)
    return types.SimpleNamespace(
        cfg=cfg, api=api, dense=dense, packed=packed,
        port_api=build_model(scale_down(ARCHS["qwen1.5-0.5b"], **SMALL),
                             device="cpu"),
        port_dense=from_reference(dense, device="cpu"),
        port_packed=from_reference(jax.tree.map(np.asarray, packed),
                                   device="cpu"))


_FAMILY = {}

#: the recurrent family's CPU size: the reference's own SME-eligible
#: override (128 wide, so the projections pack; experts of 128)
RECURRENT = {
    "jamba-v0.1-52b": dict(d_model=128, d_ff=256, vocab=256, expert_dff=128,
                           dtype="float32"),
    "xlstm-1.3b": dict(d_model=128, d_ff=0, vocab=256, dtype="float32"),
}
#: the names of the reference's tuple states, in its order
STATE_NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def ref_state(kind, state):
    """A reference recurrent state as the port's {name: numpy array}."""
    if isinstance(state, dict):
        return {k: np.asarray(v) for k, v in state.items()}
    return {k: np.asarray(v) for k, v in zip(STATE_NAMES[kind], state)}


def family_models(arch, seed=3, **over):
    """One arch of the MoE, vision or recurrent slice at
    ``ref_scale_down(**over)``:
    reference config/API/params (dense, and packed for v1, v2 and v3 from
    one compression), the port's API and the same params carried across,
    on the CPU.  Cached per (arch, seed, overrides)."""
    key = (arch, seed, tuple(sorted(over.items())))
    if key not in _FAMILY:
        cfg = ref_scale_down(REF_ARCHS[arch], **over)
        api = ref_build_model(cfg)
        dense = jax.tree.map(np.asarray, api.init_params(jax.random.key(seed)))
        dense["embed"]["w"] = dense["embed"]["w"] * np.float32(0.05)
        packed = jax.tree.map(np.asarray, ref_convert(dense, squeeze=1,
                                                      backend="all"))
        _FAMILY[key] = types.SimpleNamespace(
            cfg=cfg, api=api, dense=dense, packed=packed,
            port_api=build_model(scale_down(ARCHS[arch], **over),
                                 device="cpu"),
            port_dense=from_reference(dense, device="cpu"),
            port_packed=from_reference(packed, device="cpu"))
    return _FAMILY[key]


def dequantized(tree, *path):
    """``tree`` (numpy, reference layout) with the packed leaf at ``path``
    replaced by its dense f32 weight (the reference's ``sme_dequant_jnp``):
    what the reference can serve where it cannot take a packed leaf."""
    from repro.core.integrate import sme_dequant_jnp
    out = jax.tree.map(lambda a: a, tree)
    node = out
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = np.asarray(sme_dequant_jnp(
        jax.tree.map(jax.numpy.asarray, node[path[-1]]),
        dtype=jax.numpy.float32))
    return out
