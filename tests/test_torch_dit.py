"""The port's WAN video DiT (models/dit.py) against the JAX package's on
the CPU, at f32.

Both get the same numpy-seeded weights (the JAX tree carried by
`from_jax_params`) and the same inputs: the tiny-dit forward (t2v) and
the tiny-dit-i2v forward with CLIP-vision tokens, over a latent whose
frame, height and width grids all differ, and `rope_freqs_3d` at WAN's
head dim. Tolerance 1e-4 absolute on velocities of |v| ~ 1-5: f32
summation order over the 2-block net (measured ~1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import dit as jdit
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import dit as tdit
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params

from test_torch_parity import f32, seeded_flax_params


def dit_pair(name: str, seed: int = 0):
    """(JAX module, its f32 params, the port's module carrying them) of a
    registry DiT in f32."""
    jcfg, tcfg = f32(jreg.get_config(name)), f32(treg.get_config(name))
    jmod = jdit.VideoDiT(jcfg)
    args = [jnp.zeros((1, 2, 4, 4, jcfg.in_channels)), jnp.zeros((1,)),
            jnp.zeros((1, 5, jcfg.context_dim))]
    if jcfg.i2v:
        args.append(jnp.zeros((1, 7, jcfg.img_dim)))
    params = seeded_flax_params(jmod, seed, *args)
    tmod = tdit.VideoDiT(tcfg)
    tmod.load_state_dict(from_jax_params(flatten_params(params), tmod))
    return jmod, params, tmod.eval()


@pytest.fixture(scope="module")
def t2v_pair():
    return dit_pair("tiny-dit", 1)


@pytest.fixture(scope="module")
def i2v_pair():
    return dit_pair("tiny-dit-i2v", 2)


def _inputs(cfg, seed=3, b=2, fhw=(3, 4, 6), img_tokens=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *fhw, cfg.in_channels), dtype=np.float32)
    t = np.array([700.0, 250.0][:b], np.float32)
    ctx = rng.standard_normal((b, 9, cfg.context_dim), dtype=np.float32)
    img = (None if img_tokens is None
           else rng.standard_normal((b, img_tokens, cfg.img_dim), dtype=np.float32))
    return x, t, ctx, img


def _both(pair, x, t, ctx, img=None):
    jmod, params, tmod = pair
    jargs = [jnp.asarray(a) for a in (x, t, ctx)] + ([] if img is None else [jnp.asarray(img)])
    ref = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (x, t, ctx)),
                   None if img is None else torch.from_numpy(img)).numpy()
    return got, ref


def test_t2v_forward_matches_jax(t2v_pair):
    """tiny-dit on a [2, 3, 4, 6, 16] latent (a 3x2x3 token grid) over 9
    text tokens: the velocity [2, 3, 4, 6, 16] within 1e-4."""
    x, t, ctx, _ = _inputs(t2v_pair[2].config)
    got, ref = _both(t2v_pair, x, t, ctx)
    assert got.shape == ref.shape == x.shape
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_i2v_forward_matches_jax(i2v_pair):
    """tiny-dit-i2v on a 36-channel input with 7 CLIP-vision tokens: the
    16-channel velocity within 1e-4; without the tokens (the image
    branch skipped) too."""
    cfg = i2v_pair[2].config
    x, t, ctx, img = _inputs(cfg, seed=4, img_tokens=7)
    got, ref = _both(i2v_pair, x, t, ctx, img)
    assert got.shape == ref.shape == x.shape[:-1] + (16,)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    plain, plain_ref = _both(i2v_pair, x, t, ctx)
    np.testing.assert_allclose(plain, plain_ref, atol=1e-4, rtol=0)
    assert np.abs(plain - got).max() > 1e-3  # the image branch counts


def test_bf16_forward_tracks_f32(t2v_pair):
    """The registry's bf16 tiny-dit (the card's dtypes: bf16 linears and
    attention, f32 modulation, norms and head) on the same weights stays
    within 0.1 of the f32 velocity (bf16's 2^-8 over two blocks)."""
    _, _, tmod = t2v_pair
    bf = tdit.VideoDiT(treg.get_config("tiny-dit"))
    bf.load_state_dict(tmod.state_dict())
    assert bf.block_0.self_attn_q.weight.dtype == torch.bfloat16
    assert bf.block_0.modulation.dtype == bf.head.weight.dtype == torch.float32
    x, t, ctx, _ = (torch.from_numpy(a) if a is not None else None
                    for a in _inputs(tmod.config))
    with torch.no_grad():
        ref, got = tmod(x, t, ctx), bf(x, t, ctx)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) < 0.1


@pytest.mark.parametrize("grid", [(1, 1, 1), (3, 4, 6), (21, 30, 45), (9, 30, 30)])
def test_rope_freqs_3d_equals_jax(grid):
    """WAN's head dim 128 (22/21/21 frequency pairs) and the tiny one's 32."""
    for head_dim in (128, 32):
        assert tdit.rope_split(head_dim) == jdit.rope_split(head_dim)
        np.testing.assert_array_equal(tdit.rope_freqs_3d(head_dim, grid),
                                      jdit.rope_freqs_3d(head_dim, grid))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_pairs_equals_the_jax_rope(dtype):
    """The block's complex-product rotation against the JAX package's
    stacked apply_rope on WAN's head dim over a (3, 4, 6) grid: within 1e-6
    in f32 (one rounding of the products apart); in bf16 at most one bf16
    step (2^-8 relative) of the f32 result apart, both rounding the same
    f32 values."""
    rng = np.random.default_rng(4)
    table = tdit.rope_freqs_3d(128, (3, 4, 6))
    x = rng.standard_normal((2, 72, 3, 128), dtype=np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tdit.rotate_pairs(tx, tdit.rope_rotation(torch.from_numpy(table).float()))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = np.asarray(jdit.apply_rope(jnp.asarray(tx.float().numpy()),
                                      jnp.asarray(table, jnp.float32)))
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-6
    else:
        assert (diff <= 2.0**-8 * np.abs(want) + 1e-6).all()


def test_gated_residual_rounds_once():
    """The block's gated residual: x + y * gate in f32, rounded once into
    x's dtype, equal to the f32 result cast afterwards."""
    rng = np.random.default_rng(5)
    x, y = (torch.from_numpy(rng.standard_normal((2, 7, 16), dtype=np.float32)).bfloat16()
            for _ in range(2))
    gate = torch.from_numpy(rng.standard_normal((2, 1, 16), dtype=np.float32))
    got = tdit._gated_residual(x, y, gate)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, torch.addcmul(x.float(), y.float(), gate).bfloat16())


def test_attention_calls_per_block(t2v_pair, i2v_pair, monkeypatch):
    """Two attention calls a block (self, text cross), three in the i2v
    layout with image tokens: what chip_smoke.py's launch count reckons."""
    calls = []
    real = tdit.dot_product_attention
    monkeypatch.setattr(tdit, "dot_product_attention",
                        lambda q, k, v: calls.append(k.shape[1]) or real(q, k, v))
    for pair, img_tokens, per_block in ((t2v_pair, None, 2), (i2v_pair, 7, 3)):
        calls.clear()
        tmod = pair[2]
        x, t, ctx, img = (None if a is None else torch.from_numpy(a)
                          for a in _inputs(tmod.config, img_tokens=img_tokens))
        with torch.no_grad():
            tmod(x, t, ctx, img)
        assert len(calls) == per_block * tmod.config.depth
        assert calls[:per_block] == [3 * 2 * 3, 9, 7][:per_block]


def test_seq_axis_raises():
    cfg = dataclasses.replace(f32(treg.get_config("tiny-dit")), seq_axis="seq")
    mod = tdit.VideoDiT(cfg)
    with pytest.raises(NotImplementedError, match="step 8"):
        mod(torch.zeros(1, 1, 2, 2, 16), torch.zeros(1), torch.zeros(1, 3, 64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulated_norm_is_the_jax_blocks_modulation(dtype):
    """One layer_norm per batch row with the modulation as its affine,
    against the JAX block's LayerNorm(f32) * (1 + scale) + shift: within
    1e-5 in f32 (the affine's one rounding apart); in bf16 at most one
    bf16 step (2^-8 relative) of the f32 result, for a batch whose rows
    have their own shift and scale."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 9, 32), dtype=np.float32) * 3 + 1)
    shift, scale = (torch.from_numpy(rng.standard_normal((2, 1, 32), dtype=np.float32))
                    for _ in range(2))
    x = x.to(getattr(torch, dtype))
    got = tdit._modulated_norm(x, shift, scale)
    assert got.dtype == x.dtype and got.shape == x.shape
    normed = jax.nn.standardize(jnp.asarray(x.float().numpy()), axis=-1, epsilon=1e-6)
    want = np.asarray(normed * (1 + jnp.asarray(scale.numpy())) + jnp.asarray(shift.numpy()))
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5
    else:
        assert (diff <= 2.0**-8 * np.abs(want) + 1e-5).all()
