"""tests/test_host_store_properties.py run against the port's host and
persistent stores: the same shadow-model property test (LRU order, cap
invariant, one-tier resolvability, incremental counters) and counter
checks, with only the two store classes swapped for the port's."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.models import tensors as PT  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "reference_host_store_properties",
    Path(__file__).resolve().parents[1] / "test_host_store_properties.py")
REF_TESTS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF_TESTS)


@pytest.mark.parametrize("name", ["test_host_store_matches_shadow_spec",
                                  "test_nbytes_is_incremental_counter",
                                  "test_persistent_store_reads_are_store_bw_limited"])
def test_reference_property_holds_for_port(name, monkeypatch):
    monkeypatch.setattr(REF_TESTS, "HostTensorStore", PT.HostTensorStore)
    monkeypatch.setattr(REF_TESTS, "PersistentStore", PT.PersistentStore)
    getattr(REF_TESTS, name)()
