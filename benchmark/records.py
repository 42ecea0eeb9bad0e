"""What the per-layer readers share: the window's steady clips (all but
the traced ones), the clip each record ran, and medians."""

from __future__ import annotations

import statistics

STAGES = ("raft", "flow_completion", "image_propagation", "generation")


def steady(rec: dict) -> list:
    return [r for r in rec["records"]
            if not r["traced"] and r["frames"]
            and all(s in r["timings"] for s in STAGES)]


def clip_of(rec: dict, r: dict) -> dict:
    """The clip of the pool that record `r` ran."""
    return rec["pool"][r["index"] % len(rec["pool"])]


def median(values: list):
    return statistics.median(values) if values else None


def stage_s(rec: dict, stage: str):
    """Median seconds a clip spends in `stage` (`inpaint_video`'s
    timings, each ending in a device synchronize)."""
    return median([r["timings"][stage] for r in steady(rec)])
