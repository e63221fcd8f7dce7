"""The port's gradient compression (``repro_torch.parallel.compress``)
against the reference's ``repro.parallel.compress``, bitwise: int8
codes and scales of f32 and bf16 leaves, an all-zero leaf (the ``1e-12``
scale floor), values on exact ``.5`` rounding ties (both round half to
even), the dequantized tree, the zero residuals, and two error-feedback
rounds with the residual carried between them.  ``ef_allreduce`` runs on
gloo 'data' groups in ``test_torch_mesh_train.py``'s world."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compress as R
from repro_torch.parallel import compress as P


def _ties():
    """A leaf whose max is 127, so the scale is 1 and each value is its
    own code: halves round to the even neighbour."""
    v = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                  -126.5, 3.4999998, 0.0], np.float32)
    return v


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"blocks": [{"w": rng.standard_normal((8, 6)).astype(dtype)},
                       {"w": (rng.standard_normal((4, 5)) * 1e-3
                              ).astype(dtype)}],
            "norm": np.zeros(7, dtype),
            "ties": _ties().astype(dtype),
            "z": (rng.standard_normal(9) * 40).astype(dtype)}


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float32))
                        .to(torch.bfloat16 if a.dtype == jnp.bfloat16
                            else torch.float32), tree)


def _same(got, want):
    g = jax.tree.leaves(jax.tree.map(
        lambda t: t.float().numpy() if t.dtype == torch.bfloat16
        else t.numpy(), got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = b.astype(np.float32) if b.dtype == jnp.bfloat16 else b
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        assert np.array_equal(a, b), np.abs(a.astype(np.float64) - b).max()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_dequantize_match_reference(dtype):
    tree = _tree(0, dtype)
    for leaf in jax.tree.leaves(tree):
        rq, rs = R.quantize_int8(jnp.asarray(leaf))
        q, s = P.quantize_int8(_port(leaf))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        assert np.array_equal(P.dequantize_int8(q, s).numpy(),
                              np.asarray(R.dequantize_int8(rq, rs)))
    q, s = P.quantize_int8(torch.as_tensor(_ties()))
    assert float(s) == 1.0
    assert q.tolist() == [127, -127, 0, 2, 2, 0, -2, -2, 126, -126, 3, 0]
    q, s = P.quantize_int8(torch.zeros(5))
    assert float(s) == np.float32(1e-12) / np.float32(127.0)
    assert q.abs().sum() == 0


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_error_feedback_rounds_match_reference(dtype):
    """Two rounds of ``compress_tree``, the first from
    ``zeros_like_resid``, the second from the first's residual: codes,
    scales, residuals and ``decompress_tree`` bitwise the reference's."""
    rr = R.zeros_like_resid(_ref(_tree(0, dtype)))
    pr = P.zeros_like_resid(_port(_tree(0, dtype)))
    _same(pr, rr)
    for seed in (1, 2):
        g = _tree(seed, dtype)
        (rpk, rr) = R.compress_tree(_ref(g), rr)
        (ppk, pr) = P.compress_tree(_port(g), pr)
        _same(ppk["q"], rpk["q"])
        _same(ppk["scale"], rpk["scale"])
        _same(pr, rr)
        _same(P.decompress_tree(ppk), R.decompress_tree(rpk))
