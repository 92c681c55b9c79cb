"""The port's CLIP-vision tower (models/clip_vision.py) against the JAX
package's on the CPU, at f32, on the same numpy-seeded weights:
tiny-clip-vision (32 px, 8-px patches, penultimate tokens) on an image
of its own size and on non-square ones that take the short-side cubic
resize (antialiased when shrinking, as jax.image.resize) and the centre
crop. Tolerance 1e-4 absolute on tokens |t| ~ 1-4 (f32 summation order;
measured ~1e-6). Also the CLIPVisionEncode node's refusal and the
penultimate depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import clip_vision as jcv
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.graph import nodes_loaders as tnl
from comfyui_distributed_tpu_torch.models import clip_vision as tcv
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params

from test_torch_parity import f32, seeded_flax_params


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = f32(jreg.get_config("tiny-clip-vision")), f32(treg.get_config("tiny-clip-vision"))
    jmod = jcv.ClipVisionEncoder(jcfg)
    params = seeded_flax_params(jmod, 9, jnp.zeros((1, 32, 32, 3)))
    tmod = tcv.ClipVisionEncoder(tcfg)
    tmod.load_state_dict(from_jax_params(flatten_params(params), tmod))
    return jmod, params, tmod.eval()


@pytest.mark.parametrize("hw", [(32, 32), (40, 56), (72, 48), (20, 30)])
def test_tokens_match_jax(pair, hw):
    """17 tokens of width 48 from a [2, H, W, 3] image: (32, 32) as is,
    (40, 56) and (72, 48) shrunk on their short side then cropped, (20,
    30) enlarged."""
    jmod, params, tmod = pair
    x = np.random.default_rng(sum(hw)).random((2, *hw, 3), dtype=np.float32)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 17, 48)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_preprocess_is_not_f_interpolate():
    """The short-side resize is jax.image.resize's antialiased cubic: on a
    shrink it departs from F.interpolate's bicubic (a=-0.75, no
    antialias) by far more than rounding."""
    x = torch.from_numpy(np.random.default_rng(1).random((1, 64, 96, 3), dtype=np.float32))
    mine = tcv.preprocess(x, 32)
    other = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(32, 48),
                                            mode="bicubic").permute(0, 2, 3, 1)[:, :, 8:40]
    mean = torch.tensor(tcv.CLIP_MEAN)
    std = torch.tensor(tcv.CLIP_STD)
    assert float((mine - (other - mean) / std).abs().max()) > 0.05


def test_penultimate_depth_and_node_refusal(pair):
    _, _, tmod = pair
    assert hasattr(tmod, "block_1") and not hasattr(tmod, "block_2")
    bundle = tcv.ClipVisionBundle("tiny-clip-vision", tmod, torch.device("cpu"))
    with pytest.raises(ValueError, match="crop='center'"):
        tnl.CLIPVisionEncode().encode(bundle, torch.zeros(1, 32, 32, 3), crop="none")
    (out,) = tnl.CLIPVisionEncode().encode(bundle, torch.zeros(1, 32, 32, 3))
    assert tuple(out.tokens.shape) == (1, 17, 48)
