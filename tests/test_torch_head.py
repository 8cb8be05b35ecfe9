"""Parity of the port's field head and field against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the
Pallas kernel runs in interpret mode on the CPU. The port's CUDA kernel
itself runs only on a GPU (tests/test_torch_cuda.py and chip_smoke.py);
here its plain version, which the wrapper takes for CPU tensors, stands
for it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantavatar_tpu.models import VoxelTriplaneField as JField
from instantavatar_tpu.models.ngp import _mlp as jax_mlp
from instantavatar_tpu.models.voxel_triplane import VoxelTriplaneParams
from instantavatar_tpu.ops.fused_head import fused_field_head as jax_head
from instantavatar_torch import convert
from instantavatar_torch.kernels import (fused_field_head,
                                         fused_field_head_ref, head_cost)
from instantavatar_torch.models import VoxelTriplaneField, _mlp

E = 56  # flagship encoder width (8 voxel + 3 x 16 plane features)


def _head_weights(seed):
    """Flagship-width head: He-init weights, biases 0.1 * N(0, 1)."""
    rng = np.random.default_rng(seed)
    dims_s, dims_c = [(E, 64), (64, 16)], [(15, 64), (64, 64), (64, 3)]

    def mlp(dims):
        ws = [(rng.standard_normal(d) * np.sqrt(2 / d[0])).astype(np.float32)
              for d in dims]
        bs = [(0.1 * rng.standard_normal(d[1])).astype(np.float32)
              for d in dims]
        return ws, bs
    return (*mlp(dims_s), *mlp(dims_c))


def _bf16_input(M, seed):
    enc = np.random.default_rng(seed).standard_normal((M, E)).astype(
        np.float32)
    enc_bf = torch.as_tensor(enc).bfloat16()
    return enc_bf, enc_bf.float().numpy()   # port input, same values in f32


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _jax_mlp_head(enc32, sw, sb, cw, cb):
    geo = jax_mlp(jnp.asarray(enc32), _j(sw), _j(sb), dtype=jnp.bfloat16)
    col = jax_mlp(geo[:, 1:], _j(cw), _j(cb), final_act=jax.nn.sigmoid,
                  dtype=jnp.bfloat16)
    return np.asarray(col), np.asarray(geo[:, 0])


def test_fused_head_plain_matches_pallas_interpret():
    """Same numerics (bf16 operands, fp32 accumulation, fp32 hidden bias
    before the cast) at M=3000, not a multiple of the 1024-row TPU tile.
    Tolerance 2e-3: the two sum the fp32 products in different orders,
    which flips the bf16 rounding of an occasional hidden unit (one bf16
    ulp, 2^-8 relative); measured max 4e-4."""
    sw, sb, cw, cb = _head_weights(0)
    enc_bf, enc32 = _bf16_input(3000, 1)
    jc, js = jax_head(jnp.asarray(enc32), _j(sw), _j(sb), _j(cw), _j(cb),
                      interpret=True)
    tc, ts = fused_field_head_ref(enc_bf, _t(sw), _t(sb), _t(cw), _t(cb))
    assert tc.shape == (3000, 3) and ts.shape == (3000,)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)


def test_fused_head_gap_to_jax_mlp_is_bounded():
    """The port's head follows fused_field_head, not JAX _mlp (which adds
    hidden biases in bf16 after the cast). The gap is the price of that
    choice; bound 3e-2 (measured ~1.1e-2 colour, ~1.8e-2 sigma with
    0.1 * N(0, 1) biases)."""
    sw, sb, cw, cb = _head_weights(2)
    enc_bf, enc32 = _bf16_input(3000, 3)
    jc, js = _jax_mlp_head(enc32, sw, sb, cw, cb)
    tc, ts = fused_field_head(enc_bf, _t(sw), _t(sb), _t(cw), _t(cb))
    np.testing.assert_allclose(tc.numpy(), jc, atol=3e-2)
    np.testing.assert_allclose(ts.numpy(), js, atol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_mlp_matches_jax_mlp(dtype):
    """Port _mlp vs JAX _mlp. fp32: atol 1e-5 (summation order only).
    bf16: atol 1e-2 on outputs up to ~7 (bf16 hidden roundings may flip
    by one ulp when the fp32 sums differ in the last bit; measured 3e-3).
    """
    sw, sb, _, _ = _head_weights(4)
    enc_bf, enc32 = _bf16_input(2000, 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_mlp(jnp.asarray(enc32), _j(sw), _j(sb), dtype=jdt))
    out = _mlp(enc_bf.float(), _t(sw), _t(sb), dtype=tdt).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 if dtype == "float32"
                               else 1e-2)


def test_fused_head_dispatch_by_device():
    """CPU tensors take the plain version (no launch counted); a device
    that is neither CPU nor CUDA raises instead of falling back."""
    sw, sb, cw, cb = _head_weights(6)
    enc_bf, _ = _bf16_input(10, 7)
    before = fused_field_head.launches
    c1, s1 = fused_field_head(enc_bf, _t(sw), _t(sb), _t(cw), _t(cb))
    c2, s2 = fused_field_head_ref(enc_bf, _t(sw), _t(sb), _t(cw), _t(cb))
    assert fused_field_head.launches == before
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_field_head(enc_bf.to("meta"), _t(sw), _t(sb), _t(cw), _t(cb))


@pytest.mark.parametrize("M", [1, 1000, 1_500_000])
def test_head_cost_counts_the_head(M):
    """head_cost: per row, 2 x (56*64 + 64*16 + 15*64 + 64*64 + 64*3) =
    19,712 FLOPs and 112 bytes of bf16 input + 16 bytes of fp32 colour and
    sigma, linear in M (the kernel's bound in chip_smoke.py rests on it)."""
    assert head_cost(1, E) == (19_712, 128)
    assert head_cost(M, E) == (19_712 * M, 128 * M)
    sw, _, cw, _ = _head_weights(0)
    macs = sum(w.shape[0] * w.shape[1] for w in sw + cw)
    assert head_cost(M, E)[0] == 2 * macs * M


def test_field_apply_matches_jax():
    """VoxelTriplaneField.apply, same numpy-seeded params in both. The
    encoding is bf16 in both (rows and lerp); the head differs by the
    fused-vs-_mlp gap above, so colour/sigma use the same 3e-2 bound.
    Encodings agree to one bf16 ulp of the feature scale (atol 2e-2 on
    N(0, 0.25) features)."""
    VR, PR = 8, 16
    pnp = convert.seeded_field_params(VR, PR, seed=8)
    jfield = JField(voxel_res=VR, plane_res=PR)
    jp = VoxelTriplaneParams(
        **{k: jnp.asarray(pnp[k]) for k in ("voxel", "plane_xy", "plane_xz",
                                            "plane_yz")},
        **{k: _j(pnp[k]) for k in ("sigma_w", "sigma_b", "color_w",
                                   "color_b")})
    field = VoxelTriplaneField(voxel_res=VR, plane_res=PR, device="cpu")
    field.load_state_dict(convert.field_params_from_numpy(pnp))
    rng = np.random.default_rng(9)
    x = rng.uniform(-1.1, 1.1, (4000, 3)).astype(np.float32)
    center = np.array([0.0, -0.2, 0.1], np.float32)
    scale = np.array([2.0, 2.2, 1.8], np.float32)
    jc, js = jfield.apply(jp, jnp.asarray(x), jnp.asarray(center),
                          jnp.asarray(scale))
    xn = (x - center) / scale + 0.5
    jenc = np.asarray(jfield.encode(jp, jnp.asarray(xn))).astype(np.float32)
    with torch.no_grad():
        tc, ts = field.apply(torch.as_tensor(x), torch.as_tensor(center),
                             torch.as_tensor(scale))
        tenc = field.encode(torch.as_tensor(xn)).float().numpy()
    np.testing.assert_allclose(tenc, jenc, atol=2e-2)
    assert np.mean(np.abs(tenc - jenc)) < 1e-3
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=3e-2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=3e-2)


def test_field_init_from_generator():
    """field.init draws from the caller's torch.Generator only: the same
    seed gives the same params; features U(-1e-4, 1e-4), He-scaled
    weights (std sqrt(2 / fan_in) within 10%), zero biases."""
    def make(seed):
        f = VoxelTriplaneField(voxel_res=4, plane_res=8, device="cpu")
        f.init(torch.Generator().manual_seed(seed))
        return f
    a, b, c = make(0), make(0), make(1)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.voxel, c.voxel)
    assert a.plane_xy.abs().max() <= 1e-4 and a.voxel.std() > 1e-5
    w = a.color_w[1].detach()                           # (64, 64)
    assert abs(float(w.std()) / (2 / 64) ** 0.5 - 1) < 0.1
    assert all(not bias.any() for bias in a.sigma_b)
