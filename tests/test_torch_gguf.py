"""GGUF checkpoints in the PyTorch port against the JAX package's reader
and writer.

Bit-exact both ways: every supported tensor type written by the port is
read by the JAX reader to the same float32 bits as by the port's, and
the JAX writer's files (F32, F16, Q8_0, Q4_0, Q5_0: the types it writes)
are byte-equal to the port's and read the same by the port's reader.
K-quants raise in both. A checkpoint written as GGUF loads through the
port's load_pipeline with every parameter equal to the plain
dequantization cast to the module's dtype.
"""

import struct

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import gguf as jgguf
from comfyui_distributed_tpu_torch.models import gguf as tgguf
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import sd_checkpoint as sdc

TYPES = {"F32": tgguf.GGML_F32, "F16": tgguf.GGML_F16, "Q8_0": tgguf.GGML_Q8_0,
         "Q4_0": tgguf.GGML_Q4_0, "Q4_1": tgguf.GGML_Q4_1, "Q5_0": tgguf.GGML_Q5_0,
         "Q5_1": tgguf.GGML_Q5_1}
JAX_WRITES = ("F32", "F16", "Q8_0", "Q4_0", "Q5_0")


def tensors(seed: int, gtype: int) -> dict:
    """A ragged tensor (not a multiple of 32), a 2-D one, an all-zero block
    and a block with one spike, all of `gtype`."""
    rng = np.random.default_rng(seed)
    zero_then_spike = np.zeros(64, np.float32)
    zero_then_spike[40] = -3.5
    return {
        "ragged": (rng.standard_normal(77, dtype=np.float32), gtype),
        "matrix": (rng.standard_normal((48, 96), dtype=np.float32) * 0.02, gtype),
        "zeros_spike": (zero_then_spike, gtype),
    }


def _bits(arrays: dict) -> dict:
    return {k: np.ascontiguousarray(v).view(np.uint32) for k, v in arrays.items()}


@pytest.mark.parametrize("type_name", sorted(TYPES))
def test_the_ports_file_reads_bit_equal_in_both_readers(tmp_path, type_name):
    path = str(tmp_path / f"{type_name}.gguf")
    written = tgguf.write_gguf(path, tensors(1, TYPES[type_name]), metadata={"name": "t"})
    assert written == (tmp_path / f"{type_name}.gguf").stat().st_size
    ours, theirs = tgguf.read_gguf(path), jgguf.read_gguf(path)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert ours[key].dtype == np.float32 and ours[key].shape == theirs[key].shape
        np.testing.assert_array_equal(_bits(ours)[key], _bits(theirs)[key], err_msg=key)
    # the round trip is close to what went in (the format's own error)
    for key, (arr, _) in tensors(1, TYPES[type_name]).items():
        step = np.abs(arr).max() / (8 if type_name.startswith("Q4") else 16)
        assert np.abs(ours[key] - arr).max() <= step, key


@pytest.mark.parametrize("type_name", JAX_WRITES)
def test_the_jax_writers_file_is_the_ports_byte_for_byte(tmp_path, type_name):
    ours, theirs = str(tmp_path / "ours.gguf"), str(tmp_path / "theirs.gguf")
    tgguf.write_gguf(ours, tensors(2, TYPES[type_name]), metadata={"a": 1, "b": 0.5, "c": True})
    jgguf.write_gguf(theirs, tensors(2, TYPES[type_name]), metadata={"a": 1, "b": 0.5, "c": True})
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    read_ours, read_theirs = tgguf.read_gguf(theirs), jgguf.read_gguf(theirs)
    for key in read_theirs:
        np.testing.assert_array_equal(_bits(read_ours)[key], _bits(read_theirs)[key])


def test_k_quants_and_bad_files_raise_as_in_the_jax_package(tmp_path):
    path = str(tmp_path / "k.gguf")
    tgguf.write_gguf(path, {"k": (np.ones(32, np.float32), tgguf.GGML_F32)})
    raw = bytearray(open(path, "rb").read())
    # the tensor's ggml type: after the header (24 bytes), the alignment
    # entry (8 + 17 + 4 + 4) and the tensor's name and dims (8 + 1 + 4 + 8)
    at = 24 + 33 + 21
    assert struct.unpack_from("<I", raw, at)[0] == tgguf.GGML_F32
    struct.pack_into("<I", raw, at, 12)  # Q4_K
    open(path, "wb").write(bytes(raw))
    messages = []
    for reader in (tgguf.read_gguf, jgguf.read_gguf):
        with pytest.raises(ValueError, match="unsupported ggml type 12") as info:
            reader(path)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    (tmp_path / "bad.gguf").write_bytes(b"GGUF" + struct.pack("<I", 4) + b"\x00" * 16)
    for reader in (tgguf.read_gguf, jgguf.read_gguf):
        with pytest.raises(ValueError, match="unsupported GGUF version 4"):
            reader(str(tmp_path / "bad.gguf"))


def test_a_gguf_checkpoint_loads_as_its_plain_dequantization(tmp_path, monkeypatch):
    """tiny-unet's single-file state dict as one GGUF file, Q8_0 where a
    tensor's size is a multiple of 32, F16 elsewhere, from
    CDT_CHECKPOINT_DIR: every parameter equals the JAX reader's
    dequantization cast to the module's dtype."""
    source = tpl.load_pipeline("tiny-unet", seed=4, device="cpu")
    state = sdc.synthesize_checkpoint(source)
    entries = {k: (v.detach().float().numpy(),
                   tgguf.GGML_Q8_0 if v.numel() % 32 == 0 else tgguf.GGML_F16)
               for k, v in state.items()}
    assert {t for _, t in entries.values()} == {tgguf.GGML_Q8_0, tgguf.GGML_F16}
    path = tmp_path / "tiny-unet.gguf"
    tgguf.write_gguf(str(path), entries)
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    assert sdc.find_checkpoint("tiny-unet") == str(path)
    loaded = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    plain = {k: torch.from_numpy(v) for k, v in jgguf.read_gguf(str(path)).items()}
    expected = {}
    for part, entries_ in sdc.sd_schedules("sd1", loaded.unet.config, loaded.vae.config,
                                           tpl.get_config(loaded.te_name)).items():
        expected[part] = sdc.convert_state_dict(plain, entries_)[0]
    checked = 0
    for part, module in loaded.parts().items():
        for name, param in module.named_parameters():
            assert torch.equal(param, expected[part][name].to(param.dtype)), (part, name)
            checked += 1
    assert checked == sum(1 for m in loaded.parts().values() for _ in m.parameters())
