#!/usr/bin/env python3
"""Whether the bars of phases 21-24 (chip_smoke.py: the spatial axis over
two gloo ranks on one card) catch a planted fault:

    python3 scripts/spatial_row0_fault.py                   # the row-0 fault
    python3 scripts/spatial_row0_fault.py --faults none,no_gather,equal_norm,no_halo
    python3 scripts/spatial_row0_fault.py --faults none,no_grad_exchange,mean_of_means
    python3 scripts/spatial_row0_fault.py --faults none,detached_keys,bn_equal_shares

It runs the cases of phases 21-24 as chip_smoke.py does: the one-process
references once (phases 23's and 24's float32 steps once per launch, as
they take the ranks' values at ReLU ties), then, for each fault named, the
two sharded ranks with that fault planted in them only:
- row0: RAFT's coordinates start every rank at row 0 (models/raft.py::
  raft_iterate's coords_grid, where a rank's rows start at its first
  global row);
- no_gather: GMA's attention and aggregate run on each rank's own keys
  and values, with no gather (models/gma.py::attention and aggregate given
  no handle; the positional score then of the local rows);
- equal_norm: instance norm combines the ranks' statistics with equal
  weights, whatever their rows (nn/layers.py::instance_norm given a handle
  without its table);
- no_halo: RAFT-small's upflow8 reads no halo rows (ops/grids.py::upflow8's
  halo_rows replaced by the rank's own edge rows);
- no_grad_exchange: the gathers and halos pass no gradient back (mesh.
  stack_ranks gathering detached tensors, as before its backward was
  written): a halo row's and a gathered block's gradient never reach the
  rank that owns them;
- mean_of_means: each rank's part of the loss and metrics is its own
  pixels' mean over the spatial group's size (train/loss.py's global
  count replaced by the rank's count times the ranks): the loss is the
  mean of the ranks' means, which unequal blocks (phase 23's 24 + 16 rows)
  weigh wrongly;
- detached_keys: the estimators' gathered target fnet map passes no
  gradient back (models/raft.py::_encode_pairs gathering a detached map):
  the keys' gradient, which the lookups' backward writes into the whole
  pyramid, never reaches the fnet rows other ranks own;
- bn_equal_shares: train-mode BatchNorm weighs every rank's statistics
  alike, whatever its rows (nn/layers.py::batch_norm_train given a handle
  without its table), which phase 24's 24 + 16 rows weigh wrongly;
- none: no fault (the phases as chip_smoke.py runs them).
Each case's distance to one process is printed beside its bar, and every
case runs to its end (chip_smoke's `fail` is recorded, not raised). The
code of the checkout is not changed: the fault is patched in at run time,
in the ranks' processes, which this script starts in place of
chip_smoke.py's.

The last line is one JSON object: per fault, each case's distance, bar and
whether its checks failed. The exit code is 0 if every fault was caught by
at least one case and the run without a fault (if asked for) passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def plant_row0() -> None:
    """Every rank's RAFT coordinates start at row 0."""
    from accflow_tpu_torch.models import raft

    coords_grid = raft.coords_grid
    raft.coords_grid = lambda *a, **k: coords_grid(*a, **{**k, "row0": 0})


def plant_no_gather() -> None:
    """GMA attends over each rank's own keys and values."""
    from accflow_tpu_torch.models import gma

    attention, aggregate = gma.attention, gma.aggregate
    gma.attention = lambda model, inp, chunk=0, spatial=None: attention(model, inp, chunk)
    gma.aggregate = lambda agg, attn, motion, spatial=None: aggregate(agg, attn, motion)


def plant_equal_norm() -> None:
    """Instance norm weighs every rank's statistics alike."""
    from accflow_tpu_torch.nn import layers

    norm = layers.instance_norm
    layers.instance_norm = lambda x, eps=1e-5, spatial=None: norm(
        x, eps, None if spatial is None else spatial._replace(rows=()))


def plant_no_halo() -> None:
    """upflow8 reads each rank's own edge rows where its halo belongs."""
    import types

    from accflow_tpu_torch.ops import grids

    grids.mesh = types.SimpleNamespace(halo_rows=lambda x, sp, top, bottom, dim=2: (
        x.narrow(dim, 0, top), x.narrow(dim, x.shape[dim] - bottom, bottom)))


def plant_no_grad_exchange() -> None:
    """Gathers and halos of detached tensors: no gradient flows back."""
    from accflow_tpu_torch.parallel import mesh

    def stack_ranks(t, sp):
        mesh._count(t.numel() * t.element_size() * (sp.size - 1))
        return mesh._all_gather(t, sp.group, sp.size).to(t.device)

    mesh.stack_ranks = stack_ranks


def plant_mean_of_means() -> None:
    """Each rank's loss part over its own count times the ranks."""
    from accflow_tpu_torch.train import loss

    loss._global_count = lambda x, spatial, channel_dims: (
        x[(0,) * (x.ndim - 3 - channel_dims)].numel() * spatial.size)


def plant_detached_keys() -> None:
    """The estimators' gathered fnet map, of a detached map."""
    from accflow_tpu_torch.models import raft
    from accflow_tpu_torch.parallel import mesh

    class Mesh:  # models/raft.py's view of parallel/mesh.py
        def __getattr__(self, name):
            return getattr(mesh, name)

        @staticmethod
        def gather_rows(x, sp, dim=1):
            return mesh.gather_rows(x.detach(), sp, dim)

    raft.mesh = Mesh()


def plant_bn_equal_shares() -> None:
    """Train-mode BatchNorm weighs every rank's statistics alike."""
    from accflow_tpu_torch.nn import layers

    norm = layers.batch_norm_train
    layers.batch_norm_train = lambda *a, spatial=None, **k: norm(
        *a, spatial=None if spatial is None else spatial._replace(rows=()), **k)


FAULTS = {"none": None, "row0": plant_row0, "no_gather": plant_no_gather,
          "equal_norm": plant_equal_norm, "no_halo": plant_no_halo,
          "no_grad_exchange": plant_no_grad_exchange, "mean_of_means": plant_mean_of_means,
          "detached_keys": plant_detached_keys, "bn_equal_shares": plant_bn_equal_shares}


def main() -> int:
    if sys.argv[1:2] == ["--fault-child"]:  # one rank: --fault-child FAULT --spatial-child ...
        if FAULTS[sys.argv[2]] is not None:
            FAULTS[sys.argv[2]]()
        sys.argv[1:3] = []
        return chip_smoke.main()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", default="row0",
                    help=f"comma-separated, of {', '.join(FAULTS)} (default row0)")
    faults = ap.parse_args().faults.split(",")
    unknown = set(faults) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    if not chip_smoke.torch.cuda.is_available():
        print("spatial_row0_fault: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi("name,power.limit"))
    failures = []
    chip_smoke.fail = failures.append
    chip_smoke.build_kernels()
    cases = chip_smoke.SPATIAL_CASES + chip_smoke.SPATIAL22_CASES + chip_smoke.SPATIAL23_CASES
    ref, spread = chip_smoke.spatial_references(cases)
    k_ref = chip_smoke.spatial_k_references()
    n_ref = chip_smoke.spatial_ft_references()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fault in faults:
            # The ranks run this script, which plants the fault, then chip_smoke's child.
            ranks, secs, _ = chip_smoke.spatial_launch(
                tmp, [str(Path(__file__).resolve()), "--fault-child", fault])
            rows = {}
            for case in cases:
                before = len(failures)
                row = chip_smoke.spatial_check(case, ref[case], spread.get(case),
                                               [r[case] for r in ranks])
                rows[case] = dict(max_abs=row["max_abs"], bar=row["bar"],
                                  ratio=row["max_abs"] / row["bar"],
                                  flow_max=row["flow_max"], failed=len(failures) > before,
                                  **{k: row[k] for k in ("first_max_abs", "epe_gap_px")
                                     if k in row})
            train_ref = {**k_ref, **chip_smoke.spatial_j_references(ranks)}
            for case in chip_smoke.SPATIAL_TRAIN_KW:
                before = len(failures)
                row = chip_smoke.spatial_train_check(case, train_ref[case],
                                                     [r[case] for r in ranks], train_ref["k f32"])
                rows[case] = dict(ratio=row["ratio"], bar=row["bar"],
                                  failed=len(failures) > before)
            ft_ref = {**n_ref, **chip_smoke.spatial_m_references(ranks)}
            for case in chip_smoke.SPATIAL_FT_KW:
                before = len(failures)
                row = chip_smoke.spatial_ft_check(case, ft_ref[case], [r[case] for r in ranks],
                                                  ft_ref["n f32"])
                rows[case] = dict(ratio=row["ratio"], bar=row["bar"],
                                  failed=len(failures) > before)
            for case, r in rows.items():
                print(f"fault {fault} ({case}): {r['ratio']:.2f}x its bar"
                      + (f" (max abs {r['max_abs']:.3e} against one process, bar {r['bar']:.3e}; "
                         f"|flow| max {r['flow_max']:.3e})" if "max_abs" in r else "")
                      + f": {'FAILED' if r['failed'] else 'passed'}")
            print(f"fault {fault}: ranks in {secs:.1f} s; cases that failed: "
                  f"{sum(r['failed'] for r in rows.values())} of {len(rows)}")
            out[fault] = rows
    print(json.dumps({"spatial_faults": out}))
    caught = all(any(r["failed"] for r in rows.values()) for f, rows in out.items()
                 if f != "none")
    clean = not any(r["failed"] for r in out.get("none", {}).values())
    return 0 if caught and clean else 1


if __name__ == "__main__":
    sys.exit(main())
