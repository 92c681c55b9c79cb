"""chip_smoke.py's incident-plane checks, rehearsed on the CPU.

The elastic phase with `incident=True`, on tiny-unet: the master runs
with CDT_INCIDENT_DIR and CDT_PROFILE_DIR, the second run is profiled
(a CPU-only capture here: no CUDA kernel to find, so that check is the
card's), and the manual incident bundle is held to the run. The checks
also fail where they should: a bundle section in error, a capture that
does not start, a route that answers disabled.
"""

import os

import pytest
import torch

import chip_smoke
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.telemetry import flight, incidents, profiling

from test_torch_chip_smoke import _tiny_workflow
from test_torch_parity import one_torch_thread  # noqa: F401  (fixture)


def _phase(runs: int = 2):
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    return chip_smoke._elastic_phase(torch, bundle, "tiny-unet", _tiny_workflow(),
                                     torch.zeros((1, 64, 64, 3)), None, "cpu", runs=runs,
                                     incident=True)


def test_the_incident_checks_run_on_the_cpu(capsys, one_torch_thread):
    result = _phase()
    out = capsys.readouterr().out.splitlines()
    flight_runs = [line for line in out if line.startswith("[flight] elastic run")]
    assert len(flight_runs) == 2 and all("appended" in line for line in flight_runs)
    assert len(result["flight"]) == 2 and all(moved["appended"]["spans"] > 0
                                             for moved in result["flight"])
    (profile,) = [line for line in out if line.startswith("[profile] elastic run 2")]
    assert "capture trace-0001-elastic" in profile and "listed True" in profile
    assert "as profiled" in profile
    assert result["profile"]["bytes"] > 0 and result["profile"]["events"] >= 0
    (incident,) = [line for line in out if line.startswith("[incident] elastic run 2")]
    assert "schema problems []" in incident and "sections in error []" in incident
    assert "equal to resolved_knobs(): True" in incident
    assert 'cdt_incidents_total{trigger="manual"} +1' in incident
    assert "incident manager None" in incident
    assert result["incident"]["run_spans"] > 0
    (tap,) = [line for line in out if line.startswith("[flight] elastic tap cost")]
    assert "us an event" in tap and result["tap_cost"]["taps"] > 0
    # the profiled run's rate is not the phase's rate
    elastic = [line for line in out if line.startswith("[elastic] run 2:")]
    assert "as profiled (not comparable)" in elastic[0]
    # the phase put back what it changed
    assert "CDT_INCIDENT_DIR" not in os.environ and "CDT_PROFILE_DIR" not in os.environ
    assert profiling.get_profiler_capture() is None


def _fails(monkeypatch, message: str):
    with pytest.raises(RuntimeError, match=message):
        _phase(runs=1)


def test_a_bundle_section_in_error_fails_the_run(monkeypatch, one_torch_thread):
    real = incidents.IncidentManager.bind_server

    def broken(self, server):
        real(self, server)
        self.sources["placement"] = lambda: 1 / 0

    monkeypatch.setattr(incidents.IncidentManager, "bind_server", broken)
    _fails(monkeypatch, "bundle sections in error")


def test_a_capture_that_does_not_start_fails_the_run(monkeypatch, one_torch_thread):
    monkeypatch.setattr(profiling, "other_profiler_active", lambda: True)
    _fails(monkeypatch, "the capture did not start")


def test_a_master_without_the_incident_manager_fails_the_run(monkeypatch, one_torch_thread):
    from comfyui_distributed_tpu_torch.utils import constants

    monkeypatch.setattr(constants, "incident_dir_from_env", lambda: None)
    _fails(monkeypatch, "no incident manager")


def test_a_missing_span_close_fails_the_run(monkeypatch, one_torch_thread):
    real = flight.FlightRecorder.dump

    def lossy(self):
        dump = real(self)
        dump["spans"] = [e for e in dump["spans"] if e["data"]["name"] != "execute_prompt"]
        return dump

    monkeypatch.setattr(flight.FlightRecorder, "dump", lossy)
    _fails(monkeypatch, "flight spans miss")
