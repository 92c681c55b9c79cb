"""The port's causal video VAE (models/video_vae.py) against the JAX
package's on the CPU, at f32.

Both get the same numpy-seeded weights (`from_jax_params`):
tiny-video-vae-3d (2x temporal, 2n+1 frames) at 5, 9 and 13 frames and
a narrow copy of the WAN layout (`WAN_LIKE`: three resample levels, time
downsampled at the last two, 4n+1 frames) at 9 encode and decode, each
whole-clip and chunked (frame 0, then `temporal_downscale`-frame chunks
through the encoder; one latent frame at a time through the decoder),
against the JAX module's whole clip. Tolerance 1e-4 absolute (latents
|z| ~ 1-3, frames in [0, 1]; f32 summation order, measured ~1e-6); the
port's chunked against its whole clip within 2e-5.

Then the JAX package's own VAE cases (tests/models/test_video_vae.py),
re-asserted on the port: the frame contract, causality, the
downsampler's frame-0 bypass and window order, the upsampler's Rep
boundary, each whole-clip and in a stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import video_vae as jvv
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import video_vae as tvv
from comfyui_distributed_tpu_torch.models.io import from_jax_params

from test_torch_parity import seeded_flax_params

# the WAN VAE's structure at a narrow width (wan-vae: base 96, 2 res blocks)
WAN_LIKE = dict(base_dim=8, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                temporal_down=(False, True, True),
                latents_mean=tuple(np.linspace(-0.5, 0.5, 16).tolist()),
                latents_std=tuple(np.linspace(0.8, 2.0, 16).tolist()))


def vae_pair(config: dict, seed: int):
    """(JAX module, its params, the port's module carrying them)."""
    jcfg, tcfg = jvv.VideoVAEConfig(**config), tvv.VideoVAEConfig(**config)
    jmod = jvv.VideoVAE(jcfg)
    params = seeded_flax_params(jmod, seed, jnp.zeros((1, jcfg.temporal_downscale + 1, 16, 16, 3)))
    tmod = tvv.VideoVAE(tcfg)
    tmod.load_state_dict(from_jax_params(flatten_params(params), tmod))
    return jmod, params, tmod.eval()


TINY = dict(base_dim=16, dim_mult=(1, 2), num_res_blocks=1, temporal_down=(True,))


@pytest.fixture(scope="module")
def tiny_pair():
    return vae_pair(TINY, 5)


@pytest.fixture(scope="module")
def wan_pair():
    return vae_pair(WAN_LIKE, 6)


def test_the_tiny_config_is_the_registrys():
    assert treg.get_config("tiny-video-vae-3d") == tvv.VideoVAEConfig(**TINY)


def _clip(frames, seed, hw=(16, 24)):
    return np.random.default_rng(seed).random((1, frames, *hw, 3), dtype=np.float32)


@pytest.mark.parametrize("which, frames", [("tiny", 5), ("tiny", 9), ("tiny", 13),
                                           ("wan_like", 9)])
def test_encode_and_decode_match_jax(tiny_pair, wan_pair, which, frames):
    """Encode a [1, F, 16, 24, 3] clip and decode its latents: the port
    whole-clip and chunked against the JAX whole clip."""
    jmod, params, tmod = tiny_pair if which == "tiny" else wan_pair
    tds = tmod.config.temporal_downscale
    x = _clip(frames, frames)
    z_ref = np.array(jmod.apply(params, jnp.asarray(x), method="encode"))
    y_ref = np.array(jmod.apply(params, jnp.asarray(z_ref), method="decode"))
    assert z_ref.shape[1] == (frames - 1) // tds + 1
    assert y_ref.shape == x.shape
    with torch.no_grad():
        for chunked in (False, True):
            z = tmod.encode(torch.from_numpy(x), chunked=chunked).numpy()
            np.testing.assert_allclose(z, z_ref, atol=1e-4, rtol=0)
            y = tmod.decode(torch.from_numpy(z_ref), chunked=chunked).numpy()
            np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=0)
    assert np.abs(z_ref).max() > 0.1 and 0.01 < y_ref.std()


@pytest.mark.parametrize("frames", [5, 9, 13])
def test_chunked_equals_whole_clip(wan_pair, frames):
    """The stream's carried frames give the whole-clip function: chunked
    against whole within 2e-5 (f32 rounding of other conv shapes)."""
    _, _, tmod = wan_pair
    x = torch.from_numpy(_clip(frames, 40 + frames))
    with torch.no_grad():
        z_whole, z_chunks = tmod.encode(x, chunked=False), tmod.encode(x)
        y_whole, y_chunks = tmod.decode(z_whole, chunked=False), tmod.decode(z_whole)
    assert float((z_whole - z_chunks).abs().max()) < 2e-5
    assert float((y_whole - y_chunks).abs().max()) < 2e-5


def test_frame_contract_rejected(wan_pair):
    _, _, tmod = wan_pair
    with pytest.raises(ValueError, match="causal contract"):
        tmod.encode(torch.zeros(1, 4, 16, 16, 3))


@pytest.mark.parametrize("chunked", [False, True])
def test_temporal_causality(wan_pair, chunked):
    """A later frame changes no earlier latent frame."""
    _, _, tmod = wan_pair
    x = _clip(9, 3)
    x2 = x.copy()
    x2[:, -1] += 0.5
    with torch.no_grad():
        z1, z2 = (tmod.encode(torch.from_numpy(a), chunked=chunked) for a in (x, x2))
    np.testing.assert_allclose(z1[:, :2].numpy(), z2[:, :2].numpy(), atol=1e-6)
    assert float((z1[:, -1] - z2[:, -1]).abs().max()) > 1e-4


def _module_pair(jcls, tcls, seed, shape):
    jmod = jcls(dim=4, temporal=True)
    params = seeded_flax_params(jmod, seed, jnp.zeros(shape))
    tmod = tcls(4, True, torch.float32)
    tmod.load_state_dict(from_jax_params(flatten_params(params), tmod))
    return jmod, params, tmod


def _cf(x):  # [B, F, H, W, C] → the port's [B, C, F, H, W]
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _cl(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


def test_downsample_frame0_bypass_and_windows():
    """Frame 0 is the spatial conv's output verbatim; out[1] reads pixel
    frames 0-2 and out[2] frames 2-4; the same module as the JAX one
    whole, and in a stream of [1, 2, 2] frames."""
    jmod, params, tmod = _module_pair(jvv._Downsample, tvv._Downsample, 0, (1, 5, 8, 8, 4))
    x = np.random.default_rng(1).random((1, 5, 8, 8, 4), dtype=np.float32)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        whole = _cl(tmod(_cf(x)))
        stream = tvv._Stream()
        chunks = _cl(torch.cat([tmod(_cf(x[:, s:e]), stream)
                                for s, e in ((0, 1), (1, 3), (3, 5))], dim=2))
        x2 = x.copy()
        x2[:, 1] += 0.25
        moved = _cl(tmod(_cf(x2)))
        tmod.time_conv.conv.weight.zero_()
        tmod.time_conv.conv.bias.zero_()
        zeroed = _cl(tmod(_cf(x)))
    assert ref.shape == (1, 3, 4, 4, 4)
    np.testing.assert_allclose(whole, ref, atol=1e-5)
    np.testing.assert_allclose(chunks, ref, atol=1e-5)
    np.testing.assert_allclose(moved[:, 0], whole[:, 0], atol=1e-6)
    assert np.abs(moved[:, 1] - whole[:, 1]).max() > 1e-4
    np.testing.assert_allclose(moved[:, 2], whole[:, 2], atol=1e-6)
    np.testing.assert_allclose(zeroed[:, 0], whole[:, 0], atol=1e-6)
    np.testing.assert_allclose(zeroed[:, 1:], 0.0, atol=1e-7)


def test_upsample_rep_boundary():
    """z0 comes out un-doubled and in no window: moving z0 moves output
    frame 0 only; 1 + 2 (L - 1) frames; the same module as the JAX one
    whole, and in a stream of one latent frame at a time."""
    jmod, params, tmod = _module_pair(jvv._Upsample, tvv._Upsample, 2, (1, 3, 4, 4, 4))
    z = np.random.default_rng(2).random((1, 3, 4, 4, 4), dtype=np.float32)
    ref = np.asarray(jmod.apply(params, jnp.asarray(z)))
    with torch.no_grad():
        whole = _cl(tmod(_cf(z)))
        stream = tvv._Stream()
        chunks = _cl(torch.cat([tmod(_cf(z[:, i:i + 1]), stream) for i in range(3)], dim=2))
        z2 = z.copy()
        z2[:, 0] += 0.5
        moved = _cl(tmod(_cf(z2)))
    assert ref.shape == whole.shape == (1, 5, 8, 8, 2)
    np.testing.assert_allclose(whole, ref, atol=1e-5)
    np.testing.assert_allclose(chunks, ref, atol=1e-5)
    assert np.abs(moved[:, 0] - whole[:, 0]).max() > 1e-4
    np.testing.assert_allclose(moved[:, 1:], whole[:, 1:], atol=1e-6)


def test_a_later_downsample_chunk_must_be_even():
    _, _, tmod = _module_pair(jvv._Downsample, tvv._Downsample, 0, (1, 5, 8, 8, 4))
    stream = tvv._Stream()
    with torch.no_grad():
        tmod(torch.zeros(1, 4, 1, 8, 8), stream)
        with pytest.raises(ValueError, match="even"):
            tmod(torch.zeros(1, 4, 3, 8, 8), stream)
