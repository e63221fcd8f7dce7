"""The small model the port's serving tests share: qwen1.5-0.5b at 2 layers,
128 wide, vocab 256, f32 (ROADMAP R2), random reference weights carried
into the port with ``convert.from_reference``.  The embedding is scaled to
0.05 so the layers, not the tied head's echo of the input token, pick the
next token."""
import types

import jax
import numpy as np

from repro.configs import ARCHS as REF_ARCHS, scale_down as ref_scale_down
from repro.core.integrate import convert_params_to_sme as ref_convert
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, scale_down
from repro_torch.convert import from_reference
from repro_torch.models.model import build_model

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
