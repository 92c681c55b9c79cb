"""The port's UNet, VAE and text encoders against the JAX package's, on
the CPU in f32, with weights carried over by `from_jax_params`.

The JAX configs are the registry's tiny entries with dtype float32.
Parameters are numpy-seeded in the flax layout (tests/test_torch_parity.py),
so biases, norm scales and the UNet's out_conv are non-zero: the
out_conv is zero-initialised in both packages, which would make the
UNet predict 0 and hide everything before it.

Tolerances: both sides are f32 and differ in summation order and in
the last bit of exp/erf. Through these 10-40 layer stacks the measured
difference on a CPU is at most 3.3e-6 (UNet, outputs up to 2.3), 1.1e-6
(VAE) and 2.2e-6 (text encoders); each tolerance leaves a margin of
about ten.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.clip_bpe import _PATTERN, clean_text
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import clip_bpe as tbpe
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import text_encoder as tte
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from test_torch_parity import f32, seeded_flax_params


def _f32(name):
    return f32(jreg.get_config(name)), f32(treg.get_config(name))


def _port(module_cls, cfg, flat):
    module = module_cls(cfg)
    module.load_state_dict(from_jax_params(flat, module))
    return module.eval().requires_grad_(False)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("name, hw", [("tiny-unet-adm", (12, 12)), ("tiny-unet-adm", (5, 7)),
                                      ("tiny-unet", (8, 8))])
def test_unet_matches_flax(name, hw):
    jcfg, tcfg = _f32(name)
    jm = jreg.UNet(jcfg)
    rng = _rng(1)
    x = rng.standard_normal((2, *hw, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 16, jcfg.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, jcfg.adm_in_channels), dtype=np.float32) if jcfg.adm_in_channels else None
    params = seeded_flax_params(jm, 0, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    kw = {} if y is None else {"y": jnp.asarray(y)}
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), **kw))
    assert np.abs(ref).max() > 0.1  # the UNet's output is not the zero init
    tm = _port(type(treg.create_model(name)), tcfg, flatten_params(params))
    out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
             y=None if y is None else torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_vae_encode_decode_match_flax(hw):
    jcfg, tcfg = _f32("tiny-vae")
    jm = jreg.VAE(jcfg)
    img = _rng(2).random((1, *hw, 3), dtype=np.float32)
    params = seeded_flax_params(jm, 1, jnp.asarray(img))
    tm = _port(type(treg.create_model("tiny-vae")), tcfg, flatten_params(params))
    z_ref = np.asarray(jm.apply(params, jnp.asarray(img), method="encode"))
    z = tm.encode(torch.from_numpy(img))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-5, rtol=0)
    lat = _rng(3).standard_normal(z_ref.shape, dtype=np.float32)
    x_ref = np.asarray(jm.apply(params, jnp.asarray(lat), method="decode"))
    x = tm.decode(torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(x, x_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["tiny-te-l", "tiny-te-g", "tiny-te"])
def test_text_encoder_hidden_and_pooled_match_flax(name):
    jcfg, tcfg = _f32(name)
    jm = jte.TextEncoder(jcfg)
    jtok = jte.Tokenizer(max_length=jcfg.max_length, pad_id=jcfg.pad_token_id)
    ttok = tte.Tokenizer(max_length=tcfg.max_length, pad_id=tcfg.pad_token_id)
    texts = ["masterpiece, highly detailed", "blurry", ""]
    tokens = jtok.encode_batch(texts)
    np.testing.assert_array_equal(ttok.encode_batch(texts), tokens)
    params = seeded_flax_params(jm, 2, jnp.asarray(tokens))
    h_ref, p_ref = jm.apply(params, jnp.asarray(tokens), eos_id=jtok.eos_id)
    tm = _port(tte.TextEncoder, tcfg, flatten_params(params))
    h, p = tm(torch.from_numpy(tokens).long(), eos_id=ttok.eos_id)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=2e-5, rtol=0)
    assert p.shape[-1] == (tcfg.proj_dim or tcfg.width)


def _tiny_te_flat():
    jcfg, _ = _f32("tiny-te")
    return flatten_params(seeded_flax_params(jte.TextEncoder(jcfg), 3, jnp.zeros((1, 16), jnp.int32)))


def test_from_jax_params_raises_on_missing_key():
    flat = _tiny_te_flat()
    del flat["params/block_1/fc2/bias"]
    with pytest.raises(ValueError, match="no JAX key fills block_1.fc2.bias"):
        from_jax_params(flat, treg.create_model("tiny-te"))


def test_from_jax_params_raises_on_extra_key():
    flat = _tiny_te_flat()
    flat["params/block_9/fc2/bias"] = np.zeros((64,), np.float32)
    with pytest.raises(ValueError, match="unused JAX key params/block_9/fc2/bias"):
        from_jax_params(flat, treg.create_model("tiny-te"))


def test_from_jax_params_raises_on_shape_mismatch():
    flat = _tiny_te_flat()
    flat["params/final_ln/scale"] = np.ones((65,), np.float32)
    with pytest.raises(ValueError, match="shape of params/final_ln/scale"):
        from_jax_params(flat, treg.create_model("tiny-te"))


@pytest.mark.parametrize("text", [
    "masterpiece, highly detailed",
    "A photo of a CAT's hat, 1024x768 (8k!!) -- it'll've been: ok?",
    "naïve café résumé — déjà vu… ½ ² Ⅻ",
    "東京タワー at night, 夜景 <|endoftext|> trailing",
    "tabs\tand\nnewlines   and  spaces",
    "!<|startoftext|>x 's 'S don't",
])
def test_pre_tokenizer_and_tokenizer_match_jax(text):
    """The port pre-tokenizes with unicodedata instead of the `regex`
    package; both must split and encode identically."""
    cleaned = clean_text(text)
    assert tbpe.pre_tokenize(cleaned) == _PATTERN.findall(cleaned)
    for name in ("tiny-te-l", "tiny-te-g", "clip-g"):
        jcfg, tcfg = _f32(name)
        jtok = jte.Tokenizer(max_length=jcfg.max_length, pad_id=jcfg.pad_token_id)
        ttok = tte.Tokenizer(max_length=tcfg.max_length, pad_id=tcfg.pad_token_id)
        np.testing.assert_array_equal(ttok.encode(text), jtok.encode(text))


def test_random_init_is_seeded_and_out_conv_starts_at_zero():
    a = tpl.load_pipeline("tiny-unet", seed=3, device="cpu")
    b = tpl.load_pipeline("tiny-unet", seed=3, device="cpu")
    c = tpl.load_pipeline("tiny-unet", seed=4, device="cpu")
    wa = a.unet.down_0_res_0.conv1.weight
    assert torch.equal(wa, b.unet.down_0_res_0.conv1.weight)
    assert not torch.equal(wa, c.unet.down_0_res_0.conv1.weight)
    assert float(a.unet.out_conv.weight.abs().max()) == 0.0
    assert all(not p.requires_grad for p in a.unet.parameters())
    # a norm scale starts at 1, a bias at 0, as the flax initialisers
    assert torch.equal(a.unet.out_norm.GroupNorm_0.weight, torch.ones(32))
    assert float(a.unet.input_conv.bias.abs().max()) == 0.0


def test_unet_rejects_unported_patches():
    cfg = dataclasses.replace(treg.get_config("tiny-unet"), freeu=(1.1, 1.2, 0.9, 0.2, False))
    with pytest.raises(NotImplementedError, match="FreeU"):
        tpl.UNet(cfg)
    unet = tpl.UNet(f32(treg.get_config("tiny-unet")))
    x, t, ctx = torch.zeros((1, 8, 8, 4)), torch.zeros((1,)), torch.zeros((1, 16, 64))
    for kwargs in ({"control": torch.zeros((1, 8, 8, 32))}, {"pag": True}, {"sag_capture": True}):
        with pytest.raises(NotImplementedError, match="PAG and SAG"):
            unet(x, t, ctx, **kwargs)
