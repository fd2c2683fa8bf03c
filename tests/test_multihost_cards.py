"""One card per process: the multi-process runtime's card assignment."""

import pytest

from guacamole.parallel import multihost


@pytest.mark.parametrize(
    "hostnames, process_id, cards, card",
    [
        (["a", "a", "a", "a"], 0, 4, 0),
        (["a", "a", "a", "a"], 3, 4, 3),
        (["a", "b", "a", "b"], 2, 2, 1),
        (["a", "b"], 1, 1, 0),
        (["h0", "h0", "h1", "h1", "h1"], 4, 4, 2),
    ],
)
def test_each_process_gets_its_rank_on_its_host(
    hostnames, process_id, cards, card
):
    assert multihost.assign_card(hostnames, process_id, cards) == card


@pytest.mark.parametrize(
    "hostnames, cards", [(["a", "a", "a"], 2), (["a", "b", "b"], 1)]
)
def test_more_processes_than_cards_refuses_to_start(hostnames, cards):
    with pytest.raises(RuntimeError, match="at most one process per card"):
        multihost.assign_card(hostnames, len(hostnames) - 1, cards)


@pytest.mark.parametrize(
    "visible, count", [("0,1,2,3", 4), ("2", 1), ("", 0), ("1, 3", 2)]
)
def test_gpu_count_follows_cuda_visible_devices(monkeypatch, visible, count):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert multihost.host_gpu_count() == count


def test_gpu_count_without_nvidia_smi_is_zero(monkeypatch):
    import shutil

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert multihost.host_gpu_count() == 0
