"""TransferSpec — the declarative description of a transfer policy.

Counterpart of ``repro/core/spec.py``: the same grammar, the same capability
matrix and the same canonical string form, in pure Python.  Axes:

    kind        marshal | pointerchain | uvm      (the paper's three schemes)
    delta       dirty-bucket incremental transfers (marshal only)
    sharding    None | int dp-mesh size            (per-device arenas)
    align_elems arena slot alignment (marshal only)
    staging     blocking | double_buffered         (pipelined staging)
    device      None | index of a CUDA device      (single-device placement)

Grammar::

    spec      := kind ('+' flag)* ('@' placement)*
    kind      := 'marshal' | 'pointerchain' | 'uvm'
    flag      := 'delta' | 'db' | 'blocking' | 'align' INT
    placement := 'dp' INT | 'dev' INT

``str`` and ``parse`` round-trip exactly; ``marshal_delta`` parses as an
alias of ``marshal+delta``.  Sharded specs (``@dpK``) parse and validate
here, but executing one raises: sharded execution is not yet ported.

The capability matrix, validated once at construction — every invalid
combination raises :class:`UnsupportedSpecError`:

    axis / kind          marshal   pointerchain   uvm
    delta                   ✓           ✗           ✗
    sharding                ✓           ✓           ✓
    delta × sharding        ✓           —           —
    align_elems > 1         ✓           ✗           ✗
    staging=double_buffered ✓ (required by delta;   ✗
                               without delta only unsharded)
    device                  ✓ (exclusive with sharding, all kinds)
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

KINDS = ("marshal", "pointerchain", "uvm")
STAGINGS = ("blocking", "double_buffered")

# legacy scheme-registry names accepted by parse() as whole-spec aliases
_ALIASES = {"marshal_delta": "marshal+delta"}

_FLAG_RE = re.compile(r"^(delta|db|double_buffered|blocking|align(\d+))$")
_PLACE_RE = re.compile(r"^(dp|dev)(\d+)$")


class UnsupportedSpecError(ValueError):
    """The one canonical error for any invalid point of the capability
    matrix (and for unparseable spec strings)."""


@dataclasses.dataclass(frozen=True)
class TransferSpec:
    """One point of the transfer-policy space.  Frozen and hashable, so a
    spec is a cache/dict key."""

    kind: str = "marshal"
    delta: bool = False
    sharding: Optional[int] = None
    align_elems: int = 1
    staging: Optional[str] = None   # None -> the delta-derived default
    device: Optional[int] = None    # CUDA device index

    def __post_init__(self):
        if self.staging is None:
            object.__setattr__(
                self, "staging",
                "double_buffered" if self.delta else "blocking")
        self.validate()

    def validate(self) -> None:
        def bad(why: str) -> None:
            raise UnsupportedSpecError(f"unsupported spec {self._raw()}: {why}")

        if self.kind not in KINDS:
            bad(f"unknown kind {self.kind!r}; options: {KINDS}")
        if not isinstance(self.align_elems, int) or self.align_elems < 1:
            bad(f"align_elems must be a positive int, got {self.align_elems!r}")
        if self.align_elems != 1 and self.kind != "marshal":
            bad("align_elems is a marshalling-arena axis")
        if self.delta and self.kind != "marshal":
            bad("delta transfers require the marshalling arena")
        if self.staging not in STAGINGS:
            bad(f"unknown staging {self.staging!r}; options: {STAGINGS}")
        if self.staging == "double_buffered" and self.kind != "marshal":
            bad("double-buffered staging is owned by the marshalling arena")
        if self.delta and self.staging != "double_buffered":
            bad("delta transfers are pipelined: staging must be "
                "double_buffered (the per-buffer fence discipline)")
        if (self.staging == "double_buffered" and not self.delta
                and self.sharding is not None):
            bad("non-delta double-buffered staging is single-device only")
        if self.sharding is not None and (
                isinstance(self.sharding, bool)
                or not isinstance(self.sharding, int) or self.sharding < 1):
            bad(f"sharding must be None or a positive mesh size; "
                f"got {self.sharding!r}")
        if self.device is not None:
            if not isinstance(self.device, int) or self.device < 0:
                bad(f"device must be None or a CUDA device index, "
                    f"got {self.device!r}")
            if self.sharding is not None:
                bad("device placement and sharding are exclusive: a sharded "
                    "transfer targets the whole mesh")

    def _raw(self) -> str:
        return (f"TransferSpec(kind={self.kind!r}, delta={self.delta}, "
                f"sharding={self.sharding!r}, align_elems={self.align_elems}, "
                f"staging={self.staging!r}, device={self.device!r})")

    @property
    def name(self) -> str:
        """Legacy scheme-registry name."""
        return "marshal_delta" if self.delta else self.kind

    @property
    def num_shards(self) -> int:
        return 1 if self.sharding is None else int(self.sharding)

    def replace(self, **kw) -> "TransferSpec":
        """`dataclasses.replace` (re-validates the capability matrix)."""
        return dataclasses.replace(self, **kw)

    def __str__(self) -> str:
        out = self.kind
        if self.delta:
            out += "+delta"
        if self.align_elems != 1:
            out += f"+align{self.align_elems}"
        if self.staging == "double_buffered" and not self.delta:
            out += "+db"
        if self.sharding is not None:
            out += f"@dp{self.num_shards}"
        if self.device is not None:
            out += f"@dev{self.device}"
        return out

    @classmethod
    def parse(cls, text: "str | TransferSpec") -> "TransferSpec":
        """Inverse of ``str``; passing a spec through is the identity."""
        if isinstance(text, cls):
            return text
        if not isinstance(text, str):
            raise UnsupportedSpecError(
                f"expected a spec string or TransferSpec, got {text!r}")
        body, at, places = text.partition("@")
        body = _ALIASES.get(body, body)
        head, *flags = body.split("+")
        kw: dict = {"kind": head}

        def put(key: str, value) -> None:
            # duplicate or contradictory flags must not silently last-win
            if key in kw:
                raise UnsupportedSpecError(
                    f"cannot parse spec {text!r}: conflicting {key} flags")
            kw[key] = value

        for flag in flags:
            m = _FLAG_RE.match(flag)
            if not m:
                raise UnsupportedSpecError(
                    f"cannot parse spec {text!r}: unknown flag {flag!r}")
            if flag == "delta":
                put("delta", True)
            elif flag in ("db", "double_buffered"):
                put("staging", "double_buffered")
            elif flag == "blocking":
                put("staging", "blocking")
            else:
                put("align_elems", int(m.group(2)))
        if at:
            for place in places.split("@"):
                m = _PLACE_RE.match(place)
                if not m:
                    raise UnsupportedSpecError(
                        f"cannot parse spec {text!r}: "
                        f"unknown placement {place!r}")
                key = "sharding" if m.group(1) == "dp" else "device"
                if key in kw:
                    raise UnsupportedSpecError(
                        f"cannot parse spec {text!r}: duplicate placement")
                kw[key] = int(m.group(2))
        if kw["kind"] not in KINDS:
            raise UnsupportedSpecError(
                f"cannot parse spec {text!r}: unknown kind {kw['kind']!r}; "
                f"options: {KINDS}")
        return cls(**kw)


# the paper's original three schemes, as specs (the reference's tuple)
PAPER_SPECS = (TransferSpec("uvm"), TransferSpec("marshal"),
               TransferSpec("pointerchain"))
