"""The ONE writer every ``BENCH_*.json`` goes through.

Before this module each benchmark invented its own schema ("schema": 1 vs 2
vs "bench"/"mode" keys, some with machine info, some without).  Now every
artifact shares a uniform envelope:

```json
{
  "bench": "serve",            // which benchmark wrote it
  "bench_schema": 2,           // envelope version (bump on shape changes)
  "smoke": false,              // CI smoke mode vs full mode
  "created_unix": 1754650000,  // write time (int seconds)
  "git_sha": "abc123...",      // repo HEAD at write time (null if unknown)
  "machine": {"platform": ..., "python": ..., "cpus": ...,
              "torch": ..., "cuda": ..., "device": ..., "device_count": ...},
  ...                          // benchmark-specific payload, flattened
}
```

Payload keys must not collide with the envelope; ``write_bench`` raises if
they do, so a benchmark can never silently shadow provenance fields.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time
from typing import Dict, Optional

__all__ = ["BENCH_SCHEMA", "machine_info", "git_sha", "write_bench",
           "ENVELOPE_KEYS"]

#: version of the shared envelope (not of any benchmark's payload)
BENCH_SCHEMA = 2

ENVELOPE_KEYS = ("bench", "bench_schema", "smoke", "created_unix",
                 "git_sha", "machine")


def machine_info() -> Dict[str, object]:
    """Host + accelerator identity, best effort (never raises)."""
    info: Dict[str, object] = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpus": os.cpu_count(),
    }
    import torch
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    return info


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD commit of the repo the benchmark ran from (None if unknown)."""
    env_sha = os.environ.get("GITHUB_SHA")
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return env_sha


def write_bench(path: str, name: str, payload: Dict[str, object],
                smoke: bool = False) -> Dict[str, object]:
    """Write ``path`` as a uniform-schema bench artifact; return the doc."""
    clash = set(payload) & set(ENVELOPE_KEYS)
    if clash:
        raise ValueError(f"payload keys shadow the bench envelope: "
                         f"{sorted(clash)}")
    doc: Dict[str, object] = {
        "bench": str(name),
        "bench_schema": BENCH_SCHEMA,
        "smoke": bool(smoke),
        "created_unix": int(time.time()),
        "git_sha": git_sha(),
        "machine": machine_info(),
    }
    doc.update(payload)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False, default=float)
        f.write("\n")
    return doc
