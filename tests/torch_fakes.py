"""Test doubles shared by the port's Manager tests.

:class:`FakeStore` is a dict-backed stand-in for the native
``StoreClient``. The :func:`fake_quorum_stores` fixture (autouse in each
module that imports it) makes both packages' Managers dial one such store
per address, shared by every Manager of the test, as a real quorum store
is shared by the groups: the healset advertisements of the striped heal
(on by default in both packages) then land there instead of dialing the
scripted quorum's store address. The :func:`few_threads` fixture gives a
test two intra-op threads and restores the count after it.
"""

from __future__ import annotations

import threading

import pytest
import torch


class FakeStore:
    def __init__(self) -> None:
        self.kv: dict = {}
        self.lock = threading.Lock()

    def set(self, key, value) -> None:
        with self.lock:
            self.kv[key] = (value if isinstance(value, bytes)
                            else str(value).encode())

    def get(self, key, timeout_ms=0) -> bytes:
        with self.lock:
            if key not in self.kv:
                raise KeyError(key)
            return self.kv[key]


@pytest.fixture(autouse=True)
def fake_quorum_stores(monkeypatch) -> dict:
    """address -> :class:`FakeStore`, for every Manager built in the
    test."""
    from torchft_tpu import manager as jmanager
    from torchft_tpu_torch import manager as tmanager

    stores: dict = {}
    lock = threading.Lock()

    def client(addr, **_kw):
        with lock:
            return stores.setdefault(addr, FakeStore())

    monkeypatch.setattr(tmanager, "StoreClient", client)
    monkeypatch.setattr(jmanager, "StoreClient", client)
    return stores


@pytest.fixture
def few_threads():
    """Two intra-op threads for a test that trains several groups or runs
    ``train_lm`` in-process (beside the other test workers a full pool
    spends the run waiting for cores), and the count restored after it:
    the next test in the same process runs with its own."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
