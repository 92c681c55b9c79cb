"""CLIPTextEncodeSDXL and the SDXL size conditioning in the port against
the JAX package, on the CPU in f32, on tiny-unet-adm (the SDXL layout:
two towers, an adm vector of the pooled text and six 256-d Fourier size
embeddings), with the same numpy-seeded weights in both packages.

- The node's conditioning: per-tower prompts, the pooled vector from the
  second tower, `size_cond` on the entry.
- The model function with and without `size_cond` (the adm vector takes
  the override before the zero-crop default), and through a batched CFG
  pair, whose entry keeps it.

Tolerances: f32 on both sides, a margin of about ten over the difference
measured on a CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_core as jcore
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.ops import conditioning as jcond
from comfyui_distributed_tpu_torch.graph import nodes_core as tcore
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from test_torch_parity import jax_and_port_bundles, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = dict(width=2048, height=1536, crop_w=32, crop_h=16, target_width=1024,
             target_height=768)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet-adm", te_name="tiny-te-l", te2_name="tiny-te-g")


@pytest.mark.parametrize("text_g, text_l", [("a castle", "a castle"),
                                            ("a castle on a hill", "oil painting, warm light")])
def test_clip_text_encode_sdxl_matches_jax(pair, text_g, text_l):
    jb, tb = pair
    (ref,) = jcore.CLIPTextEncodeSDXL().encode(jb, text_g=text_g, text_l=text_l, **SIZES)
    (got,) = tcore.CLIPTextEncodeSDXL().encode(tb, text_g=text_g, text_l=text_l, **SIZES)
    assert got.size_cond == ref.size_cond == (1536, 2048, 16, 32, 768, 1024)
    # measured 1.4e-6 on a CPU
    np.testing.assert_allclose(got.context.numpy(), np.asarray(ref.context), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(ref.pooled), atol=2e-5, rtol=0)
    if text_g == text_l:  # one prompt for both towers: CLIPTextEncode's encoding
        plain = tpl.encode_text_pooled(tb, [text_g])
        torch.testing.assert_close(got.context, plain.context, rtol=0, atol=0)


def test_the_sdxl_node_needs_two_towers():
    tb = tpl.load_pipeline("tiny-unet", device="cpu")
    with pytest.raises(ValueError, match="dual-tower"):
        tcore.CLIPTextEncodeSDXL().encode(tb, text_g="a", text_l="a")


def _entry_pair(seed, size_cond):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((1, 16, 160), dtype=np.float32)
    pooled = rng.standard_normal((1, 96), dtype=np.float32)
    return (jcond.Conditioning(jnp.asarray(ctx), pooled=jnp.asarray(pooled), size_cond=size_cond),
            tcond.Conditioning(torch.from_numpy(ctx), pooled=torch.from_numpy(pooled),
                               size_cond=size_cond))


@pytest.mark.parametrize("size_cond", [None, (1536, 2048, 16, 32, 768, 1024)],
                         ids=["latent size, zero crops", "size_cond"])
def test_the_model_function_takes_the_size_override(pair, size_cond):
    """The adm vector's six size embeddings from `size_cond`, else from the
    latent with zero crops: the eps of both packages' model functions."""
    jb, tb = pair
    jc, tc = _entry_pair(1, size_cond)
    x = np.random.default_rng(2).standard_normal((1, 6, 8, 4), dtype=np.float32)
    sig = np.full((1,), 2.5, np.float32)
    ref = np.asarray(jpl._make_model_fn(jb, jb.params)(jnp.asarray(x), jnp.asarray(sig), jc))
    with torch.no_grad():
        fn = tpl._make_model_fn(tb)
        got = fn(torch.from_numpy(x), torch.from_numpy(sig), tc).numpy()
        other = tcond.Conditioning(tc.context, pooled=tc.pooled,
                                   size_cond=None if size_cond else (64, 64, 0, 0, 64, 64))
        moved = fn(torch.from_numpy(x), torch.from_numpy(sig), other).numpy()
    assert np.abs(got - moved).max() > 1e-4  # the size conditioning counts
    # measured 2.9e-6 on a CPU
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


def test_a_batched_cfg_pair_keeps_the_size_override(pair):
    """Both sides carry the same size_cond, so they ride one 2B pass (the
    JAX package's rule), and the batched entry still has it."""
    jb, tb = pair
    (jpos, tpos), (jneg, tneg) = (_entry_pair(s, (512, 768, 0, 0, 1024, 1024)) for s in (3, 4))
    x = np.random.default_rng(5).standard_normal((1, 4, 4, 4), dtype=np.float32)
    sig = np.full((1,), 6.0, np.float32)
    ref = np.asarray(jpl.guided_model(jb, jb.params, 4.0)(jnp.asarray(x), jnp.asarray(sig),
                                                          (jpos, jneg)))
    calls = []
    handle = tb.unet.register_forward_pre_hook(
        lambda module, args, kwargs: calls.append(kwargs["y"]), with_kwargs=True)
    try:
        with torch.no_grad():
            got = tpl.guided_model(tb, 4.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                            (tpos, tneg)).numpy()
    finally:
        handle.remove()
    assert len(calls) == 1 and calls[0].shape[0] == 2  # one batched pass
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
