"""Shared CLI plumbing for the indexer and engine entry points.

Port of ``image_search_engine_tpu/utils/cli.py``: one definition of the
scale-out flags, so they cannot drift between the two commands.
"""

from __future__ import annotations

import argparse


def add_scaleout_args(ap: argparse.ArgumentParser, verb: str) -> None:
    """--sharded / --dcn-* / --no-compile-cache, shared by the indexer and
    the engine. ``verb`` names the action in the help ("serve", "build")."""
    ap.add_argument("--sharded", type=int, nargs="?", const=0, default=None, metavar="N",
                    help=f"{verb} over a 1-D mesh of the first N local devices (no N = "
                         "all; on the CPU, N shards of the one CPU); the multi-device "
                         "layout (parallel/)")
    ap.add_argument("--dcn-coordinator", default=None, metavar="HOST:PORT",
                    help="join a multi-process job before meshing: process 0's address; "
                         "give all three --dcn-* on every process, or '--dcn-coordinator "
                         "auto' under torchrun (its environment names the job)")
    ap.add_argument("--dcn-processes", type=int, default=None)
    ap.add_argument("--dcn-process-id", type=int, default=None)
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="accepted for the JAX package's CLI; the port has no compile "
                         "cache (its kernels build once per checkout under build/)")


def apply_scaleout_args(a: argparse.Namespace) -> dict:
    """The Config keyword arguments of the flags."""
    return dict(shard_devices=a.sharded, dcn_coordinator=a.dcn_coordinator,
                dcn_num_processes=a.dcn_processes, dcn_process_id=a.dcn_process_id)
