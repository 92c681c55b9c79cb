"""The port's T5 encoder and tokenizer against the JAX package's
(comfyui_distributed_tpu/models/t5_encoder.py) on the CPU, at f32.

The same numpy-seeded weights (carried by `from_jax_params`) and token
ids go through both encoders: the Flux layout (tiny-t5-shared, one
relative-position table for the stack) and the UMT5 one (a table per
block). The tokenizers give the same ids (the committed CLIP BPE, folded
into a smaller vocab), the bucket tables are equal, a T5 file in the HF
layout loads into both, and a SentencePiece path is refused by the port
rather than tokenized with BPE ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import sd_checkpoint as jsdc
from comfyui_distributed_tpu.models import t5_encoder as jt5
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import sd_checkpoint as tsdc
from comfyui_distributed_tpu_torch.models import t5_encoder as tt5
from comfyui_distributed_tpu_torch.models.io import from_jax_params

from test_torch_parity import seeded_flax_params

PROMPTS = ["a red fox standing on a mossy log in a misty forest at sunrise, cinematic lighting",
           "", "make the sky a vivid sunset", "x " * 40]


@pytest.fixture(autouse=True)
def no_spm(monkeypatch):
    monkeypatch.delenv("CDT_T5_SPM", raising=False)


def _configs(per_layer: bool):
    """(JAX config, port config) of tiny-t5-shared in f32, or its UMT5
    variant with a table per block."""
    base = dataclasses.asdict(treg.get_config("tiny-t5-shared"))
    base.update(dtype="float32", per_layer_rel_bias=per_layer)
    return jt5.T5EncoderConfig(**base), tt5.T5EncoderConfig(**base)


def _pair(per_layer: bool, seed: int = 4):
    jcfg, tcfg = _configs(per_layer)
    jm = jt5.T5Encoder(jcfg)
    params = seeded_flax_params(jm, seed, jnp.zeros((1, jcfg.max_length), jnp.int32))
    tm = tt5.T5Encoder(tcfg)
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    return jm, params, tm.eval().requires_grad_(False)


@pytest.mark.parametrize("per_layer", [False, True], ids=["shared_bias", "per_layer_bias"])
def test_encoder_matches_jax(per_layer):
    """Hidden states and the masked-mean pooled vector of three prompts
    (one empty: only </s> unmasked) through the 2-block encoder; 2e-5
    absolute on RMS-normed states (f32 summation order)."""
    jm, params, tm = _pair(per_layer)
    tok = tt5.T5Tokenizer(max_length=16, vocab_size=49408)
    ids = tok.encode_batch(PROMPTS[:3])
    assert (ids == 0).any() and (ids != 0).any()
    ref_h, ref_p = jax.jit(jm.apply)(params, jnp.asarray(ids))
    got_h, got_p = tm(torch.from_numpy(ids.astype(np.int64)))
    assert got_h.dtype == torch.float32 and got_h.shape == (3, 16, 64)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=2e-5, rtol=0)
    assert ("rel_bias.weight" in tm.state_dict()) != per_layer


@pytest.mark.parametrize("length, buckets, distance", [(1, 32, 128), (16, 32, 128),
                                                       (77, 32, 128), (512, 32, 128),
                                                       (300, 16, 64)])
def test_relative_position_buckets_equal_jax(length, buckets, distance):
    np.testing.assert_array_equal(tt5.relative_position_buckets(length, buckets, distance),
                                  jt5.relative_position_buckets(length, buckets, distance))


@pytest.mark.parametrize("max_length, vocab", [(16, 49408), (512, 32128), (8, 100)])
def test_tokenizer_ids_equal_jax(max_length, vocab):
    """The CLIP BPE ids, truncated to max_length - 1, then </s>, folded
    into [2, vocab) where the vocab is smaller than the BPE's."""
    ref = jt5.T5Tokenizer(max_length=max_length, vocab_size=vocab).encode_batch(PROMPTS)
    got = tt5.T5Tokenizer(max_length=max_length, vocab_size=vocab).encode_batch(PROMPTS)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), max_length)
    np.testing.assert_array_equal(got, ref)
    assert got.max() < vocab


def test_a_sentencepiece_path_is_refused(monkeypatch, tmp_path):
    """The port reads no SentencePiece model: with CDT_T5_SPM set it raises
    naming the variable, where a silent BPE fallback would condition a
    real checkpoint on wrong ids."""
    spm = tmp_path / "spiece.model"
    spm.write_bytes(b"\0")
    monkeypatch.setenv("CDT_T5_SPM", str(spm))
    with pytest.raises(NotImplementedError, match="CDT_T5_SPM"):
        tt5.T5Tokenizer(max_length=16)
    with pytest.raises(NotImplementedError, match="CDT_T5_SPM"):
        tt5.T5Tokenizer(max_length=16, spm_path=str(spm))


@pytest.mark.parametrize("prefix", ["", "text_encoders.t5xxl.transformer."])
def test_a_t5_file_loads_the_jax_weights(prefix):
    """The JAX package's schedule synthesizes an HF-layout file (bare, or
    nested as in an SD3 single file) from its weights; the port's
    load_t5_weights reads every parameter back exactly."""
    jm, params, tm = _pair(per_layer=False, seed=9)
    cfg = tm.config
    flat = flatten_params(params)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             jsdc.synthesize_state_dict(flat, jsdc.t5_encoder_schedule(cfg, prefix=prefix)).items()}
    fresh = tt5.T5Encoder(cfg)
    tsdc.load_t5_weights(state, cfg, fresh)
    for key, value in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0, atol=0, msg=key)
    del state[f"{prefix}encoder.final_layer_norm.weight"]
    with pytest.raises(ValueError, match="final_norm"):
        tsdc.load_t5_weights(state, cfg, tt5.T5Encoder(cfg))
