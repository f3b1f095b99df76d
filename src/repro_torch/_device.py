"""Device resolution for every entry point of the port.

The device comes from the caller, never from what happens to be present:
``None`` means the CUDA card (``cuda:N`` when a spec says ``@devN``), and the
CPU is used only when the caller passes ``device="cpu"`` (as the tests do);
the meta device only when the caller passes ``device="meta"`` (the dry run).
Without a card, a call that did not ask for the CPU raises instead of
quietly running there.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Union[None, str, int, torch.device]


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was required (the default) but none is usable."""


def resolve_device(device: DeviceLike = None,
                   index: Optional[int] = None) -> torch.device:
    """The ``torch.device`` a call runs on.

    ``device`` is what the caller passed (``None``, ``"cpu"``, ``"cuda"``,
    ``"cuda:1"``, an int or a ``torch.device``); ``index`` is a spec's
    ``@devN`` placement, used when the caller named no CUDA index.
    ``"meta"`` (the dry run's positions: shapes without data) is
    accepted only when passed; nothing resolves to it otherwise.
    """
    if device is None:
        dev = torch.device("cuda", index or 0)
    elif isinstance(device, int):
        dev = torch.device("cuda", device)
    else:
        dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use a CUDA device, "
                         f"device='cpu' or (for the dry run) device='meta'")
    if dev.index is None:
        dev = torch.device("cuda", index or 0)
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            f"{dev} requested but torch.cuda.is_available() is False; pass "
            f"device='cpu' to run on the CPU")
    if dev.index >= torch.cuda.device_count():
        raise NoCudaDeviceError(
            f"{dev} requested but only {torch.cuda.device_count()} CUDA "
            f"device(s) are visible")
    return dev


_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The dedicated host-to-device copy stream of a CUDA device (one per
    device and process, created on first use)."""
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (nothing to wait for on the
    CPU, where every op has already run)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Barrier:
    """One pass's barrier over every device it copied to: the CUDA events
    recorded after each device's last copy.  It completes when all of them
    have (no events: nothing was queued, as on the CPU)."""

    def __init__(self, events):
        self.events = [e for e in events if e is not None]

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()
