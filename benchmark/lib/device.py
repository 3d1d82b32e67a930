"""The card a run uses, and what ``nvidia-smi`` says of it."""

from __future__ import annotations

import subprocess
import sys

import torch

SMI_FIELDS = ("power.limit", "clocks.sm", "clocks.max.sm", "temperature.gpu")


def require_cards(n: int) -> torch.device:
    """``cuda:0`` where at least ``n`` cards are visible; otherwise say why
    on standard error and exit 2, before any result is printed."""
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: this benchmark runs on the card only\n")
        raise SystemExit(2)
    if torch.cuda.device_count() < n:
        sys.stderr.write(f"the cell needs {n} cards, {torch.cuda.device_count()} are visible\n")
        raise SystemExit(2)
    return torch.device("cuda", 0)


def smi() -> dict:
    """SMI_FIELDS of card 0, as nvidia-smi prints them, or {} where it
    cannot be read."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--id=0", f"--query-gpu={','.join(SMI_FIELDS)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return {}
    vals = [v.strip() for v in res.stdout.strip().split(",")]
    return dict(zip(SMI_FIELDS, vals)) if res.returncode == 0 and len(vals) == len(SMI_FIELDS) else {}


def record(dev: torch.device, count: int, peak: int) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
           "memory_peak_bytes": int(peak), "visible_cards": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    out.update({k.replace(".", "_"): v for k, v in smi().items()})
    return out
