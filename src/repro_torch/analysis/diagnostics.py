"""Diagnostic records, the code registry and the suppression baseline.

Every analyzer pass emits ``Diagnostic`` records keyed by a stable code
(table below). ``python -m repro_torch.analysis --check`` fails on any
diagnostic that the suppression baseline (``baseline.json`` beside this
file) does not match: the baseline is an explicit, reviewed allowlist in
which every entry carries the code, the subject and a reason.

Codes
-----
RA001  a kernel or its oracle raised at the contract's probe shapes
       (contract unverifiable)
RA002  kernel and oracle outputs disagree (shapes, dtypes, or hits on
       gap-safe probe inputs), or break the declared dtype policy
RA003  declared padding (multiple of 32) or tile invariant violated
RA004  kernel contract declares no plain PyTorch oracle
RA101  the threshold a CUDA wrapper passes to its C entry point is not
       the canonical one bit for bit (the ``float(eps) ** 2`` f64 -> fp32
       bug class), or the wrapper passes none
RA102  a reduction to one int32 value during an engine run (wraps
       silently at paper scale; counters sum in int64 and report fp32)
RA103  a host read of a device value inside a kernel wrapper (the
       wrapper would wait for the card instead of launching)
RA104  a float64 tensor while a wrapper prepares its operands or while
       an oracle runs (the kernels' programs are fp32)
RA110  a cached function reads module state that is not part of its
       cache key
RA201  bytes moved under no channel, or under a channel that
       ``RunStats.comm_bytes`` lacks
RA202  the bytes moved per channel differ from the ``RunStats``
       formula times the engine runs
RA301  module unreachable from the public entry points (dead code)
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

CODES = {
    "RA001": "contract probe failure",
    "RA002": "kernel/oracle output or dtype-policy mismatch",
    "RA003": "tile shape / %32 padding invariant violated",
    "RA004": "missing plain PyTorch oracle",
    "RA101": "non-canonical threshold passed to a kernel",
    "RA102": "int32 scalar reduction in an engine run",
    "RA103": "host read of a device value in a kernel wrapper",
    "RA104": "float64 in an fp32 program",
    "RA110": "cache key incompleteness",
    "RA201": "uncounted comm channel",
    "RA202": "moved comm bytes != RunStats formula",
    "RA301": "dead module",
}


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding. ``subject`` is the stable identity used for
    baseline matching (kernel name, engine config, module name); the
    message is free-form detail."""

    code: str
    subject: str
    message: str = field(compare=False)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    def render(self) -> str:
        return f"{self.code} [{self.subject}] {self.message}"

    def to_json(self) -> dict:
        return asdict(self)


DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: str | Path | None = None) -> list[dict]:
    """Baseline entries: [{"code", "subject", "reason"}, ...]."""
    p = Path(path) if path is not None else DEFAULT_BASELINE
    if not p.exists():
        return []
    return json.loads(p.read_text())


def is_baselined(diag: Diagnostic, baseline: list[dict]) -> bool:
    return any(b["code"] == diag.code and b["subject"] == diag.subject
               for b in baseline)


def split_baselined(
    diags: list[Diagnostic], baseline: list[dict]
) -> tuple[list[Diagnostic], list[Diagnostic]]:
    """-> (not baselined, baselined)."""
    fresh, known = [], []
    for d in diags:
        (known if is_baselined(d, baseline) else fresh).append(d)
    return fresh, known


def write_baseline(diags: list[Diagnostic], path: str | Path,
                   reason: str = "accepted by --write-baseline") -> None:
    entries = [{"code": d.code, "subject": d.subject, "reason": reason}
               for d in sorted(set(diags), key=lambda d: (d.code, d.subject))]
    Path(path).write_text(json.dumps(entries, indent=1) + "\n")
