"""The inpainting checkpoint (a 9-channel UNet) and InpaintModelConditioning
in the port against the JAX package, on the CPU in f32, on
tiny-unet-inpaint with numpy-seeded weights carried by `from_jax_params`
(its conv_in takes 9 channels) and the JAX package's noise handed to the
port.

- InpaintModelConditioning's outputs: the concat channels (the mask at
  latent resolution, then the gray-filled pixels' latents) on both
  conditionings, the starting latents and the noise mask; 1e-5 of the
  largest |x|.
- KSampler over them: the UNet's input call by call (the scaled noisy
  latents and the 5 concat channels, batch-2 CFG), and the sampled
  latents; 5e-5 per unit of the largest |x| (f32 summation order).
- The concat channels follow a batch slice and an area crop, and the
  tile path refuses them, as in the JAX package.
- A single file whose UNet conv_in takes 9 channels loads as the
  inpainting model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_core as jnc
from comfyui_distributed_tpu_torch.graph import nodes_core as tnc
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import tiles as tile_ops
from comfyui_distributed_tpu_torch.ops import upscale as tup
from test_torch_image_nodes import assert_same
from test_torch_parity import jax_and_port_bundles, jax_noise, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(51)
PIXELS = RNG.random((1, 32, 32, 3), dtype=np.float32)
MASK = np.zeros((32, 32), np.float32)
MASK[10:22, 10:22] = 1.0


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet-inpaint")


def _encode_both(pair):
    jb, tb = pair
    ctx = [RNG.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2)]
    from comfyui_distributed_tpu.ops import conditioning as jcond

    jout = jnc.InpaintModelConditioning().encode(
        jcond.Conditioning(jax.numpy.asarray(ctx[0])), jcond.Conditioning(
            jax.numpy.asarray(ctx[1])), jb, jax.numpy.asarray(PIXELS), jax.numpy.asarray(MASK))
    tout = tnc.InpaintModelConditioning().encode(
        tcond.Conditioning(torch.from_numpy(ctx[0])), tcond.Conditioning(torch.from_numpy(ctx[1])),
        tb, torch.from_numpy(PIXELS), torch.from_numpy(MASK))
    return jout, tout


def test_inpaint_model_conditioning_matches_jax(pair):
    (jpos, jneg, jlat), (tpos, tneg, tlat) = _encode_both(pair)
    assert tuple(tpos.concat_latent.shape) == (1, 16, 16, 5)
    assert tpos.concat_latent is tneg.concat_latent
    for got, ref in ((tpos, jpos), (tneg, jneg)):
        assert_same(got.concat_latent, ref.concat_latent)
        assert_same(got.context, ref.context)
    assert_same(tlat, jlat)
    # the mask channel is the latent-resolution mask; the rest differ
    # from the plain encode only where it is set
    np.testing.assert_array_equal(tpos.concat_latent[..., :1].numpy(),
                                  tlat["noise_mask"].numpy())


def _recording_unet(unet, record):
    class Recording(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = unet

        def forward(self, x, *args, **kwargs):
            record.append(x.detach().clone().numpy())
            return self.inner(x, *args, **kwargs)

    return Recording()


def _recording_flax(unet, record):
    class Recording:
        def apply(self, params, x, *args, **kwargs):
            jax.debug.callback(lambda a: record.append(np.asarray(a)), x, ordered=True)
            return unet.apply(params, x, *args, **kwargs)

    return Recording()


def test_sampling_with_concat_channels_matches_jax_call_by_call(pair, monkeypatch):
    jb, tb = pair
    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    (jpos, jneg, jlat), (tpos, tneg, tlat) = _encode_both(pair)
    jcalls, tcalls = [], []
    jrec = dataclasses.replace(jb, unet=_recording_flax(jb.unet, jcalls))
    trec = dataclasses.replace(tb, unet=_recording_unet(tb.unet, tcalls))
    (jout,) = jnc.KSampler().sample(jrec, 19, 3, 7.0, "euler", "karras", jpos, jneg, jlat,
                                    denoise=1.0)
    jax.effects_barrier()
    (tout,) = tnc.KSampler().sample(trec, 19, 3, 7.0, "euler", "karras", tpos, tneg, tlat,
                                    denoise=1.0)
    assert len(tcalls) == len(jcalls) == 3
    for got, ref in zip(tcalls, jcalls):
        assert got.shape == ref.shape == (2, 16, 16, 9)
        # the concat channels are the same on every call and both halves
        np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * float(np.abs(ref).max()))
    ref = np.asarray(jout["samples"])
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(tout["samples"].numpy(), ref, rtol=0,
                               atol=5e-5 * float(np.abs(ref).max()))
    # the inpainting pin: outside the mask the latents are the encoded ones
    keep = tlat["noise_mask"].numpy() == 0
    np.testing.assert_array_equal(np.where(keep, tout["samples"].numpy(), 0),
                                  np.where(keep, tlat["samples"].numpy(), 0))


def test_a_4_channel_unet_refuses_concat_channels():
    bundle = tpl.load_pipeline("tiny-unet", device="cpu")
    cond = tcond.Conditioning(torch.zeros((1, 16, 64)), concat_latent=torch.zeros((1, 4, 4, 5)))
    with pytest.raises(RuntimeError):
        tpl.guided_model(bundle, 1.0)(torch.zeros((1, 4, 4, 4)), torch.ones(1), (cond, cond))


def test_concat_channels_follow_batch_slices_and_area_crops():
    """slice_batch cuts them with the batch; composite_eps crops them with
    an area (a concat plane of the latent's size), as the JAX package's
    samplers.py does; a batch of one broadcasts."""
    concat = torch.arange(2 * 6 * 8 * 5, dtype=torch.float32).reshape(2, 6, 8, 5)
    cond = tcond.Conditioning(torch.zeros((2, 3, 4)), concat_latent=concat)
    assert torch.equal(tcond.slice_batch(cond, 1, 1).concat_latent, concat[1:2])
    seen = []

    def model(x, sigma, c):
        seen.append((tuple(x.shape), c.concat_latent))
        return torch.zeros_like(x)

    area = tcond.Conditioning(torch.zeros((2, 3, 4)), concat_latent=concat, area=(24, 32, 16, 8))
    tsmp.composite_eps(model, torch.zeros((2, 6, 8, 4)), torch.ones(2), area)
    (shape, crop), = seen
    assert shape == (2, 3, 4, 4) and torch.equal(crop, concat[:, 2:5, 1:5, :])


def test_the_tile_path_refuses_concat_channels():
    grid = tile_ops.calculate_tiles(64, 64, 32, 32, 8)
    cond = tcond.Conditioning(torch.zeros((1, 3, 4)), concat_latent=torch.zeros((1, 8, 8, 5)))
    with pytest.raises(ValueError, match="InpaintModelConditioning"):
        tup.prep_cond_for_tiles(cond, grid)


def test_a_9_channel_checkpoint_loads_as_the_inpainting_model(pair, tmp_path):
    """A file written from tiny-unet-inpaint's weights, asked for as
    tiny-unet, loads as tiny-unet-inpaint with every parameter equal to
    the written one in the registry config's dtype."""
    _, tb = pair
    path = tmp_path / "tiny-unet.safetensors"
    sdc.save_safetensors(sdc.synthesize_checkpoint(tb), str(path))
    loaded = tpl.load_pipeline("tiny-unet", device="cpu", checkpoint=str(path))
    assert loaded.model_name == "tiny-unet-inpaint"
    assert loaded.unet.input_conv.weight.shape[1] == 9
    for (name, a), b in zip(tb.unet.state_dict().items(), loaded.unet.state_dict().values()):
        torch.testing.assert_close(b, a.to(b.dtype), rtol=0, atol=0, msg=name)
    assert sdc.sniff_model_name({}, "sd15") == "sd15"
    assert sdc.sniff_model_name({sdc.UNET_CONV_IN: torch.zeros(320, 9, 3, 3)},
                                "sd15") == "sd15-inpaint"
