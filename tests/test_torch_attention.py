"""The port's attention router and the kernel's plain version against the
JAX package's flash attention, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages in
f32. Tolerances: both sides compute softmax(q k^T / sqrt(D)) v in f32
and differ only in summation order, which moves an output by ~1e-6 at
these sizes; 2e-5 absolute leaves a margin of ten.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import attention as jax_attn
from comfyui_distributed_tpu_torch.ops import attention as attn

ATOL = 2e-5


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, n, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
        rng.standard_normal((b, m, h, d), dtype=np.float32),
    )


@pytest.mark.parametrize("shape", [(2, 256, 2, 64, 256), (1, 128, 2, 128, 256)])
def test_plain_matches_pallas_kernel_interpret(shape):
    """Aligned shapes reach the JAX package's Pallas kernel itself
    (interpret mode on the CPU)."""
    b, n, h, d, m = shape
    q, k, v = _qkv(0, b, n, m, h, d)
    ref = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out = attn.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "b, n, m, h, d",
    [
        (2, 81, 77, 2, 64),     # ragged self and cross lengths
        (2, 324, 324, 2, 64),   # the 18x18 UNet level of a 576-px tile
        (2, 324, 77, 2, 64),    # its cross-attention on 77 text tokens
        (1, 200, 200, 1, 512),  # the VAE mid-block head dim
    ],
)
def test_router_matches_jax_on_ragged_shapes(b, n, m, h, d):
    """Lengths off the TPU kernel's 128 grid: the JAX package computes
    them with jax.nn.dot_product_attention, the port with the plain
    version on the CPU."""
    q, k, v = _qkv(1, b, n, m, h, d)
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.dtype == torch.float32 and out.shape == (b, n, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(2, 1, 128, 128, 2, 64)
    ref = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3, interpret=True
    )
    out = attn.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_router_launches_no_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 64, 64, 2, 64))
    before = attn.flash_attention.launches
    attn.dot_product_attention(q, k, v)
    assert attn.flash_attention.launches == before == 0


def test_plain_version_keeps_bf16_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(4, 1, 40, 30, 1, 64))
    out = attn.dot_product_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = attn.flash_attention_reference(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2, rtol=2**-7)


@pytest.mark.parametrize(
    "q_shape, k_shape, dtype, match",
    [
        ((1, 8, 2, 48), (1, 8, 2, 48), torch.float32, "head dims"),
        ((1, 8, 2, 64), (1, 8, 2, 64), torch.float16, "float32 or bfloat16"),
        ((1, 8, 2, 64), (1, 8, 3, 64), torch.float32, "disagree"),
        ((1, 8, 64), (1, 8, 64), torch.float32, r"\[B, N, H, D\]"),
        ((1, 8, 2, 64), (1, 0, 2, 64), torch.float32, "M >= 1"),
        ((1, 8, 2, 64), (1, 8, 2, 64), torch.float32, "CUDA tensors"),
    ],
)
def test_kernel_wrapper_rejects_what_it_does_not_take(q_shape, k_shape, dtype, match):
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        attn.flash_attention(q, k, k)
    assert attn.flash_attention.launches == 0


def test_kernel_wrapper_rejects_strided_head_dim():
    q = torch.zeros((1, 8, 2, 128))[..., ::2]
    with pytest.raises(ValueError, match="contiguous last"):
        attn.flash_attention(q, q, q)


class _SwitchingCounts(dict):
    """Per-instance counts that hand the interpreter lock to another thread
    between reading a count and writing it back, so an unguarded
    read-modify-write loses updates every time threads interleave."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_lose_nothing_under_threads():
    """Two participants of one process launch from their own threads: 8
    threads x 1000 launches through the counting path lose no count."""
    import sys
    import threading

    attn.reset_launch_counts()
    attn.flash_attention.launches_by_instance = _SwitchingCounts(dict.fromkeys(attn.INSTANCES, 0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)

        def launch(instance):
            barrier.wait(timeout=10)
            for _ in range(1000):
                attn.count_launch(instance)

        threads = [threading.Thread(target=launch, args=(("wgmma", "wgmma512")[i % 2],))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert attn.flash_attention.launches == 8000
    assert dict(attn.flash_attention.launches_by_instance) == {
        "fma": 0, "wgmma": 4000, "wgmma512": 4000}
    attn.reset_launch_counts()
    assert attn.flash_attention.launches == 0
    assert type(attn.flash_attention.launches_by_instance) is dict


def _fake_nvcc(monkeypatch, tmp_path, gate=None):
    """nvcc stand-in: records each output name and writes an empty file
    there; a link (`-shared`) waits until `gate` (a barrier) lets it
    through."""
    from comfyui_distributed_tpu_torch import _build

    outputs = []

    def fake_run(cmd, **kwargs):
        if gate is not None and "-shared" in cmd:
            gate.wait(timeout=10)
        outputs.append(cmd[cmd.index("-o") + 1])
        open(outputs[-1], "wb").close()
        return type("Done", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    return outputs


def _in_threads(fn, n):
    import threading

    threads = [threading.Thread(target=fn) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_kernel_library_loads_once_for_racing_threads(monkeypatch, tmp_path):
    """Four threads reaching their first launch together build and load
    one library, and all get it."""
    import ctypes
    import threading

    outputs = _fake_nvcc(monkeypatch, tmp_path)
    loads = []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.cdt_flash_attention_fwd = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
            self.cdt_flash_attention_blocks_per_sm = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(attn.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(attn, "_library", None)
    barrier = threading.Barrier(4)
    loaded = []

    def first_launch():
        barrier.wait(timeout=10)
        loaded.append(attn.load_library())

    _in_threads(first_launch, 4)
    from comfyui_distributed_tpu_torch import _build

    # one build: each group's object, then the link
    assert len(outputs) == _build.PARTS["flash_attention.cu"] + 1 and len(loads) == 1
    assert len(loaded) == 4 and all(result is loaded[0] for result in loaded)


def test_two_builders_in_one_process_write_separate_temporary_files(monkeypatch, tmp_path):
    """Two threads inside nvcc at once (each build's link runs until both
    are there) write different temporary files, their groups' objects
    too, then one library lands and no object is left."""
    import threading

    from comfyui_distributed_tpu_torch import _build

    outputs = _fake_nvcc(monkeypatch, tmp_path, gate=threading.Barrier(2))
    results = []
    _in_threads(lambda: results.append(_build.build("flash_attention.cu")), 2)
    parts = _build.PARTS["flash_attention.cu"]
    assert len(set(outputs)) == len(outputs) == 2 * (parts + 1)
    assert all(f".{os.getpid()}." in name for name in outputs)
    assert sum(name.endswith(".tmp") for name in outputs) == 2
    assert sum(name.endswith(".o") for name in outputs) == 2 * parts
    assert results[0].path == results[1].path and os.path.exists(results[0].path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(results[0].path)]


def test_the_grouped_build_compiles_each_group_once_then_links(monkeypatch, tmp_path):
    """The kernel source's instances form PARTS groups (CDT_PARTS in the
    source): one nvcc -c per group with its CDT_PART, then one link of
    their objects; a source of one group compiles in one run."""
    from comfyui_distributed_tpu_torch import _build

    outputs = _fake_nvcc(monkeypatch, tmp_path)
    calls = []
    fake_run = _build.subprocess.run
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or fake_run(cmd, **kw))
    parts = _build.PARTS["flash_attention.cu"]
    library = _build.build("flash_attention.cu").path
    compiles, link = calls[:-1], calls[-1]
    assert sorted(a for c in compiles for a in c if a.startswith("-DCDT_PART=")) == \
        sorted(f"-DCDT_PART={k}" for k in range(1, parts + 1))
    assert all("-c" in c and f"-DCDT_PARTS={parts}" in c and "-shared" not in c
               for c in compiles)
    assert "-shared" in link and sorted(link[-parts:]) == sorted(outputs[:parts])
    src = open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")).read()
    assert f"CDT_PARTS == {parts}" in src
    os.remove(library)
    calls.clear()
    monkeypatch.setitem(_build.PARTS, "flash_attention.cu", 1)
    _build.build("flash_attention.cu")
    assert len(calls) == 1 and "-shared" in calls[0] and "-c" not in calls[0]


@pytest.mark.parametrize("chunk_elements", [2 * 3 * 37 * 5, 2 * 3 * 37, 1])
def test_the_plain_version_takes_query_row_chunks(chunk_elements, monkeypatch):
    """Past REFERENCE_CHUNK_ELEMENTS scores the plain versions go in
    chunks of query rows (WAN's [2, 28350, 40, 128] self-attention would be
    257 GB of f32 scores whole); rows are independent, so the result is the
    whole one's within f32 rounding (a one-row product takes another CPU
    kernel: measured ~1e-7)."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 37, 3, 64, generator=gen) for _ in range(3))
    whole = attn.flash_attention_reference(q, k, v)
    emulated = attn.bf16_p_attention_reference(q, k, v, 16)
    assert attn._query_row_chunks(q, 37) == [slice(0, 37)]
    monkeypatch.setattr(attn, "REFERENCE_CHUNK_ELEMENTS", chunk_elements)
    chunks = attn._query_row_chunks(q, 37)
    assert len(chunks) > 1 and chunks[-1].stop == 37
    torch.testing.assert_close(attn.flash_attention_reference(q, k, v), whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(attn.bf16_p_attention_reference(q, k, v, 16), emulated,
                               rtol=0, atol=1e-6)
    monkeypatch.setattr(attn, "REFERENCE_CHUNK_ELEMENTS", 2 * 3 * 37 * 37)
    assert attn._query_row_chunks(q, 37) == [slice(0, 37)]
