"""Audio in the port against the JAX package, on the CPU:

- the float32 base64 envelope (tests/test_codecs.py's round trip, bad
  envelopes and combine) and the size cap, with equal envelopes;
- LoadAudio (a PCM WAV of 8, 16 and 32 bits, and a .npz) and SaveAudio
  against the JAX nodes;
- AudioBatchDivider's parts against the JAX node's;
- /distributed/job_complete decoding an envelope's audio, and answering
  400 on one that does not decode, as the JAX route does;
- the collector's audio path over HTTP on two port servers (master + w1,
  each reading its own WAV): the master's combined audio equals what the
  JAX collector combines from the same master audio and w1's envelope.
"""

import os
import types
import wave

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_audio as jnodes_audio
from comfyui_distributed_tpu.graph.nodes_distributed import AudioBatchDivider as JaxDivider
from comfyui_distributed_tpu.graph.nodes_distributed import (
    DistributedCollector as JaxCollector,
)
from comfyui_distributed_tpu.utils import audio_payload as jpayload
from comfyui_distributed_tpu.utils.exceptions import DistributedError as JaxDistributedError
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_audio
from comfyui_distributed_tpu_torch.graph.nodes_distributed import (
    AudioBatchDivider,
    DistributedCollector,
)
from comfyui_distributed_tpu_torch.utils import audio_payload
from comfyui_distributed_tpu_torch.utils.exceptions import DistributedError

from test_torch_collector import _envelope, _post, master_only  # noqa: F401  (fixture)
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

CPU = types.SimpleNamespace(device="cpu", config=None)


def _wave(seed, shape=(1, 2, 1000)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# the envelope
# --------------------------------------------------------------------------


def test_the_envelope_round_trips_and_equals_the_jax_one():
    wave_ = _wave(2)
    payload = audio_payload.encode_audio_payload(wave_, 44100)
    assert payload == jpayload.encode_audio_payload(wave_, 44100)
    out, rate = audio_payload.decode_audio_payload(payload)
    assert rate == 44100
    np.testing.assert_array_equal(out, wave_)
    # a tensor is taken as its host copy
    assert audio_payload.encode_audio_payload(torch.from_numpy(wave_), 44100) == payload
    jout, _ = jpayload.decode_audio_payload(payload)
    np.testing.assert_array_equal(jout, out)


@pytest.mark.parametrize("change", [
    {"shape": [1, 1, 99]}, {"dtype": "float16"}, "no data", "not a dict", "no rate"])
def test_a_bad_envelope_is_refused_as_the_jax_decoder_refuses_it(change):
    payload = audio_payload.encode_audio_payload(np.zeros((1, 1, 10), np.float32), 16000)
    if change == "no data":
        bad = {"data": "xx"}
    elif change == "not a dict":
        bad = ["data"]
    elif change == "no rate":
        bad = {k: v for k, v in payload.items() if k != "sample_rate"}
    else:
        bad = {**payload, **change}
    with pytest.raises(DistributedError) as port_error:
        audio_payload.decode_audio_payload(bad)
    with pytest.raises(JaxDistributedError) as jax_error:
        jpayload.decode_audio_payload(bad)
    assert str(port_error.value) == str(jax_error.value)


def test_the_size_cap_holds_both_ways(monkeypatch):
    from comfyui_distributed_tpu_torch.utils import audio_payload as module

    monkeypatch.setattr(module, "MAX_AUDIO_PAYLOAD_BYTES", 16)
    with pytest.raises(DistributedError, match="exceeds cap 16"):
        module.encode_audio_payload(np.zeros((1, 1, 5), np.float32), 8000)
    monkeypatch.setattr(module, "MAX_AUDIO_PAYLOAD_BYTES", 1 << 20)
    payload = module.encode_audio_payload(np.zeros((1, 1, 5), np.float32), 8000)
    monkeypatch.setattr(module, "MAX_AUDIO_PAYLOAD_BYTES", 16)
    with pytest.raises(DistributedError, match="size cap"):
        module.decode_audio_payload(payload)


def test_combine_concatenates_the_samples_axis_as_the_jax_combine():
    a, b = np.ones((1, 2, 5), np.float32), _wave(3, (1, 2, 3))
    combined, rate = audio_payload.combine_audio([(a, 8000), (b, 8000)])
    jcombined, jrate = jpayload.combine_audio([(a, 8000), (b, 8000)])
    assert combined.shape == (1, 2, 8) and rate == jrate == 8000
    np.testing.assert_array_equal(combined, jcombined)
    for bad in ([(a, 8000), (b, 16000)], []):
        with pytest.raises(DistributedError):
            audio_payload.combine_audio(bad)


# --------------------------------------------------------------------------
# the nodes
# --------------------------------------------------------------------------


def _write_wav(path, width, channels=2, frames=300, seed=4):
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    pcm = np.random.default_rng(seed).integers(info.min, info.max, (frames, channels),
                                               dtype=dtype, endpoint=True)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(22050)
        wf.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width", [1, 2, 4])
def test_load_audio_reads_a_wav_as_the_jax_node(tmp_path, width):
    path = str(tmp_path / f"a{width}.wav")
    _write_wav(path, width)
    (port,) = nodes_audio.LoadAudio().load(path, CPU)
    (jax_,) = jnodes_audio.LoadAudio().load(path)
    assert port["sample_rate"] == jax_["sample_rate"] == 22050
    assert isinstance(port["waveform"], torch.Tensor) and port["waveform"].device.type == "cpu"
    assert port["waveform"].shape == (1, 2, 300)
    np.testing.assert_array_equal(port["waveform"].numpy(), jax_["waveform"])


def test_save_then_load_audio_as_the_jax_nodes(tmp_path):
    wave_ = _wave(5, (2, 1, 40))
    written = {}
    for name, module, context, value in (
            ("port", nodes_audio, types.SimpleNamespace(device="cpu", config={"settings": {
                "output_dir": str(tmp_path / "port")}}), torch.from_numpy(wave_)),
            ("jax", jnodes_audio, types.SimpleNamespace(config={"settings": {
                "output_dir": str(tmp_path / "jax")}}), wave_)):
        (result,) = module.SaveAudio().save({"waveform": value, "sample_rate": 16000},
                                            "clip", context=context)
        path = os.path.join(str(tmp_path / name), result["ui"]["audio"][0])
        with np.load(path) as data:
            written[name] = (result["ui"], data["waveform"].copy(), int(data["sample_rate"]))
        assert result["audio"]["waveform"] is value
    assert written["port"][0] == written["jax"][0] == {"audio": ["clip.npz"]}
    np.testing.assert_array_equal(written["port"][1], written["jax"][1])
    assert written["port"][2] == written["jax"][2] == 16000
    (loaded,) = nodes_audio.LoadAudio().load(str(tmp_path / "port" / "clip.npz"), CPU)
    (jloaded,) = jnodes_audio.LoadAudio().load(str(tmp_path / "port" / "clip.npz"))
    np.testing.assert_array_equal(loaded["waveform"].numpy(), jloaded["waveform"])
    assert loaded["sample_rate"] == jloaded["sample_rate"] == 16000


@pytest.mark.parametrize("samples, divide_by", [(10, 3), (10, 1), (7, 10), (3, 12), (0, 2)])
def test_the_audio_divider_splits_as_the_jax_node(samples, divide_by):
    wave_ = _wave(6, (1, 2, samples))
    port = AudioBatchDivider().divide({"waveform": torch.from_numpy(wave_), "sample_rate": 8},
                                      divide_by)
    jax_ = JaxDivider().divide({"waveform": wave_, "sample_rate": 8}, divide_by)
    assert len(port) == len(jax_) == 10
    for part, jpart in zip(port, jax_):
        assert part["sample_rate"] == jpart["sample_rate"] == 8
        np.testing.assert_array_equal(part["waveform"].numpy(), jpart["waveform"])
    np.testing.assert_array_equal(
        torch.cat([p["waveform"] for p in port], dim=-1).numpy(), wave_)


# --------------------------------------------------------------------------
# the route and the collector
# --------------------------------------------------------------------------


def test_job_complete_decodes_audio_and_refuses_an_undecodable_payload(master_only):
    good = _envelope(0.5)
    good["audio"] = audio_payload.encode_audio_payload(_wave(7, (1, 2, 50)), 8000)
    status, answer = _post(master_only, good)
    assert (status, answer) == (200, {"status": "ok"})
    item = master_only.job_store.collectors["job"].queue.get_nowait()
    np.testing.assert_array_equal(item["audio"][0], _wave(7, (1, 2, 50)))
    assert item["audio"][1] == 8000
    bad = _envelope(0.5, batch_idx=1)
    bad["audio"] = {**good["audio"], "shape": [1, 2, 51]}
    status, answer = _post(master_only, bad)
    assert status == 400 and answer["error"].startswith("undecodable audio: ")
    status, answer = _post(master_only, {**_envelope(0.5, batch_idx=2), "audio": "nope"})
    assert status == 400 and "audio payload must be a dict" in answer["error"]


def test_the_collector_combines_audio_over_http_as_the_jax_collector(tmp_path, port_loop,
                                                                     one_torch_thread):
    """The model-free audio graph (chip_smoke's `_audio_workflow`) on a
    port master and w1, each loading its own WAV: the master's audio then
    w1's, and AudioBatchDivider's parts back to it; the JAX collector
    given the same master audio and w1's envelope combines the same."""
    import chip_smoke

    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(in_dir)
    with chip_smoke._serving(str(tmp_path), {"input_dir": in_dir, "output_dir": out_dir},
                             "cpu") as (master, _worker, base, worker_port):
        result = chip_smoke._audio_check(master, base, worker_port, in_dir, out_dir, "cpu")
        combined = np.load(os.path.join(out_dir, "combined.npz"))["waveform"]
    assert result["samples"] == 2 * chip_smoke.AUDIO_SECONDS * chip_smoke.AUDIO_RATE
    mine = {name: nodes_audio.LoadAudio().load(os.path.join(in_dir, name), CPU)[0]
            for name in ("master.wav", "w1.wav")}
    envelope = DistributedCollector.envelopes(torch.zeros((1, 4, 4, 3)), "w1", "job",
                                              mine["w1.wav"])[-1]
    item = {"worker_id": "w1", "batch_idx": 0, "tensor": np.zeros((4, 4, 3), np.float32),
            "is_last": True, "audio": jpayload.decode_audio_payload(envelope["audio"])}
    collector = JaxCollector()
    collector._drain_worker_results = lambda *args: [item]
    _, jax_audio = collector._collect_master(
        np.zeros((1, 4, 4, 3), np.float32),
        {"waveform": mine["master.wav"]["waveform"].numpy(), "sample_rate": 44100}, "job",
        ["w1"], types.SimpleNamespace(server=object()))
    np.testing.assert_array_equal(combined, np.asarray(jax_audio["waveform"]))
    assert jax_audio["sample_rate"] == chip_smoke.AUDIO_RATE


def test_a_worker_sends_its_audio_on_its_last_envelope_only():
    audio = {"waveform": torch.from_numpy(_wave(8, (1, 1, 6))), "sample_rate": 8000}
    envelopes = DistributedCollector.envelopes(torch.zeros((3, 2, 2, 3)), "w1", "j", audio)
    assert [("audio" in e, e["is_last"]) for e in envelopes] == [
        (False, False), (False, False), (True, True)]
    empty = DistributedCollector.envelopes(torch.zeros((0, 2, 2, 3)), "w1", "j", audio)
    assert len(empty) == 1 and empty[0]["empty"] and "audio" in empty[0]
    decoded, rate = audio_payload.decode_audio_payload(envelopes[-1]["audio"])
    np.testing.assert_array_equal(decoded, audio["waveform"].numpy())
    assert rate == 8000


def test_the_master_combines_its_audio_then_the_workers_in_arrival_order(master_only):
    """Two workers' envelopes, w2's arriving first: the combined audio is
    the master's, then w2's, then w1's (the JAX collector's arrival
    order), while the images follow the configured worker order."""
    waves = {who: _wave(seed, (1, 2, 4 + seed)) for seed, who in enumerate(("master", "w1",
                                                                           "w2"))}
    for who in ("w2", "w1"):
        envelope = _envelope(0.25 if who == "w1" else 0.75, worker_id=who)
        envelope["audio"] = audio_payload.encode_audio_payload(waves[who], 8000)
        assert _post(master_only, envelope)[0] == 200
    context = ExecutionContext(device="cpu", config=master_only.config, server=master_only)
    images, audio = DistributedCollector().run(
        torch.full((1, 8, 8, 3), 0.5), {"waveform": torch.from_numpy(waves["master"]),
                                        "sample_rate": 8000},
        job_id="job", enabled_worker_ids=["w1", "w2"], context=context)
    assert [round(float(images[i].mean()), 2) for i in range(3)] == [0.5, 0.25, 0.75]
    np.testing.assert_array_equal(
        audio["waveform"].numpy(),
        np.concatenate([waves["master"], waves["w2"], waves["w1"]], axis=-1))
    assert audio["sample_rate"] == 8000 and isinstance(audio["waveform"], torch.Tensor)
    assert "job" not in master_only.job_store.collectors  # cleaned up once drained
