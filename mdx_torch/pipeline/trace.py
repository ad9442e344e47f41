"""PHI-safe structured trace logging (ref pipeline/agent_logger.py).

Per-run in-memory trace with phase_start/prompt/tool_call/iteration/info/
phase_end events.  Every string is sanitised: control characters stripped,
PHI-looking patterns redacted, 2000-char truncation.

The port's copy of ``mdx/pipeline/trace.py``.  Device-timing events
(``log_device_timing``) record the wall-clock milliseconds of each phase
of a run (decode, normalize, device QA, report, PNG, DB) next to the
semantic trace.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

_PHI_PATTERN = re.compile(
    r"patient\s*(name|id|dob|birth|ssn)\s*[:=]\s*\S+", re.IGNORECASE)
_CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")
_MAX_LEN = 2000


def sanitise_text(text: str) -> str:
    text = _CTRL.sub("", str(text))
    text = _PHI_PATTERN.sub("[REDACTED]", text)
    return text[:_MAX_LEN]


@dataclass
class TraceEntry:
    timestamp: float
    phase: str
    event: str
    detail: str

    def to_dict(self) -> Dict[str, Any]:
        return {"timestamp": self.timestamp, "phase": self.phase,
                "event": self.event, "detail": self.detail}


@dataclass
class AgentTraceLogger:
    entries: List[TraceEntry] = field(default_factory=list)

    def _add(self, phase: str, event: str, detail: str) -> None:
        self.entries.append(TraceEntry(time.time(), sanitise_text(phase),
                                       event, sanitise_text(detail)))

    def log_phase_start(self, phase: str, detail: str = "") -> None:
        self._add(phase, "phase_start", detail)

    def log_phase_end(self, phase: str, detail: str = "") -> None:
        self._add(phase, "phase_end", detail)

    def log_prompt(self, phase: str, prompt: str) -> None:
        self._add(phase, "prompt", prompt)

    def log_tool_call(self, phase: str, tool: str, detail: str = "") -> None:
        self._add(phase, "tool_call", f"{tool}: {detail}" if detail else tool)

    def log_iteration(self, phase: str, iteration: int, detail: str = "") -> None:
        self._add(phase, "iteration", f"iter {iteration}: {detail}")

    def log_info(self, phase: str, detail: str) -> None:
        self._add(phase, "info", detail)

    def log_device_timing(self, phase: str, wall_ms: float,
                          device: str = "") -> None:
        self._add(phase, "device_timing",
                  f"{wall_ms:.2f} ms{' on ' + device if device else ''}")

    def to_list(self) -> List[Dict[str, Any]]:
        return [e.to_dict() for e in self.entries]
