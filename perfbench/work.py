"""The work that the rooflines divide: what the plain reference computes on
the traffic's work sample (``bwt_extend`` calls with their occurrence
lines and words, SMEM intervals, band cells of the chain extension), the
same reads in every run, counted once in a checkout and cached beside the
configuration's genome.

A run scales the sample's work per read to the reads of its window.  The
sample is fixed, so the scaled work does not move from run to run: a
roofline moves only with the kernel's device time.
"""
from __future__ import annotations

import json
import os

from . import traffic as traffic_mod
from .check import options
from .reference.fm import RefIndex, Work
from .reference.records import Engine, align1_regs


def count(ref: RefIndex, traffic: dict, genome) -> dict:
    """The reference's work on the traffic's work sample, and its reads."""
    opt = options(traffic)
    eng = Engine(ref)
    saved, ref.work = ref.work, Work()
    try:
        units = traffic_mod.work_units(traffic, genome)
        for q in units:
            align1_regs(opt, eng, q)
        return dict(reads=len(units), **ref.work.as_dict())
    finally:
        ref.work = saved


def cached(cache: str, traffic_name: str, ref: RefIndex, traffic: dict,
           genome) -> dict:
    """``count``, from ``cache/work.<traffic>.json`` where an earlier run of
    the checkout left it."""
    path = os.path.join(cache, f"work.{traffic_name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    work = count(ref, traffic, genome)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(work, f)
    os.replace(tmp, path)
    return work
