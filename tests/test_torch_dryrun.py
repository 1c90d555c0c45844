"""The port's dry run (``repro_torch.launch.dryrun``): one rank's step of a
cell on the production meshes over a fake process group, and its record
(its dot FLOPs against the reference's are
``test_torch_dryrun_reference{,_ssm,_hybrid}.py``'s).

- **The records**: ``main`` on a full-size cell of each mesh writes
  ``"ok"`` records with the reference's keys; a full-attention arch's
  ``long_500k`` is ``"skipped"``; the full sweep's records, when present
  (the twin of ``test_dryrun_artifacts_complete_if_present``).
- **What the dry run repaired**, each at the smallest fake world and size
  that showed it: the chunked cross-entropy's gather on vocab-sharded
  logits beyond one chunk of 512 (also on real tensors over gloo, where a
  training step of S > 512 raised: ``test_torch_multidevice_cross_
  entropy.py``), and the prefill's ``nonzero`` cache write (a
  data-dependent shape).
- **A fault the comparison found** (ROADMAP §3): falcon-mamba's x_proj
  backward contracts over the whole d_inner on every rank of "model"
  (zamba2's are ``test_torch_dryrun_faults.py``'s).
"""
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)


ROOT = Path(__file__).resolve().parents[1]
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "status", "plan",
               "plan_overrides", "chips", "lower_s", "compile_s",
               "cost_analysis", "memory_analysis", "hlo"}
HLO_KEYS = {"dot_flops_per_device", "traffic_bytes_per_device",
            "collective_bytes_per_device", "collective_counts",
            "wire_bytes_per_device", "top_collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes"}


# ------------------------------- records ---------------------------------- #
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from repro_torch.launch import dryrun
    out = tmp_path_factory.mktemp("port_dryrun")
    rc = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                      "--mesh", "both", "--out", str(out)])
    assert rc == 0
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


@pytest.mark.parametrize("mesh,chips", [("single", 256), ("multi", 512)])
def test_main_writes_an_ok_record(records, mesh, chips):
    """smollm-360m's 15 heads over a model axis of 16 (the chunk rule)."""
    rec = records[f"smollm-360m__decode_32k__{mesh}"]
    assert rec["status"] == "ok" and rec["chips"] == chips
    assert RECORD_KEYS <= set(rec)
    assert HLO_KEYS <= set(rec["hlo"])
    assert MEMORY_KEYS <= set(rec["memory_analysis"])
    hlo = rec["hlo"]
    assert hlo["dot_flops_per_device"] > 0
    assert sum(hlo["collective_counts"].values()) > 0
    assert hlo["top_collectives"] and all(
        set(c) == {"kind", "dtype", "dims", "mult", "bytes", "op"}
        for c in hlo["top_collectives"])
    assert rec["memory_analysis"]["argument_bytes"] > 0


def test_the_multi_pod_mesh_halves_the_rank_work(records):
    """Twice the devices, the same global batch: the larger mesh's rank
    holds half the cache and does half the products of the batch."""
    one, two = (records[f"smollm-360m__decode_32k__{m}"]
                for m in ("single", "multi"))
    assert two["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert two["hlo"]["dot_flops_per_device"] < \
        one["hlo"]["dot_flops_per_device"]


def test_summary_tables_the_records(records, tmp_path, capsys):
    from repro_torch.launch import dryrun
    for name, rec in records.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    assert dryrun.main(["--summary", "--out", str(tmp_path)]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 3 and rows[2].startswith(
        "| smollm-360m | ok: 2.375e+09 / 1.188e+09 FLOPs, ")


def test_long_500k_is_skipped_for_full_attention(tmp_path):
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(tmp_path)]) == 0
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"smollm-360m__long_500k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "skipped" and "sub-quadratic" in \
            rec["reason"]


def test_port_dryrun_artifacts_complete_if_present():
    """When the full sweep has written its records, every runnable cell is
    "ok" with dot FLOPs, and every long_500k full-attention cell is
    skipped, on both meshes."""
    art = ROOT / "artifacts" / "port_dryrun"
    if not art.exists() or len(list(art.glob("*.json"))) < 80:
        pytest.skip("full dry-run sweep artifacts not present")
    from repro_torch.configs import all_cells
    recs = {}
    for f in art.glob("*.json"):
        r = json.loads(f.read_text())
        if r.get("plan_overrides"):
            continue
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    for arch, shape, runnable, why in all_cells():
        for mesh in ("single", "multi"):
            r = recs.get((arch, shape, mesh))
            assert r is not None, (arch, shape, mesh)
            if runnable:
                assert r["status"] == "ok", (arch, shape, mesh,
                                             r.get("error", ""))
                assert r["hlo"]["dot_flops_per_device"] > 0
            else:
                assert r["status"] == "skipped"


# --------------------- what the dry run repaired --------------------------- #
def _trace(arch, kind, S, B, mesh_shape):
    """One rank's step of ``arch``'s smoke config over a fake world."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import plan_for
    cfg = REGISTRY[arch].smoke()
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    with fake_world(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, axes)
        shape = ShapeConfig("t", S, B, kind)
        return dryrun._trace(cfg, shape, plan_for(cfg, shape, mesh), mesh)


@pytest.mark.parametrize("arch", ["smollm-360m", "nemotron-4-15b"])
def test_cross_entropy_beyond_one_chunk_on_vocab_shards(arch):
    """S = 513: two chunks of the cross-entropy, the logits' vocab over a
    model axis of 2.  torch 2.13's gather rule raised "too many indices for
    tensor of dimension 2" here (``_ops/_mask_buffer.py``); the pick is
    now a ``map_local`` body per vocab shard (``common._picked``)."""
    rec = _trace(arch, "train", 513, 2, (1, 2))
    assert rec["status"] == "ok" and rec["hlo"]["dot_flops_per_device"] > 0
    assert rec["hlo"]["collective_counts"]["all-reduce"] > 0


def test_prefill_cache_write_has_no_data_dependent_shape():
    """A prefill into a cache whose sequence is sharded over "model": the
    owned-entry write took ``nonzero`` (no shape under fake tensors, and
    a host sync a layer on real ones); ``attention.write_chunk`` is now a
    scatter of indices, a gather and a ``where``."""
    rec = _trace("smollm-360m", "prefill", 16, 2, (1, 2))
    assert rec["status"] == "ok" and rec["hlo"]["dot_flops_per_device"] > 0


# ------------------- a fault the comparison found ------------------------- #
def test_falcon_x_proj_backward_takes_the_whole_inner_dim():
    """ROADMAP §3: in falcon-mamba's train step at (2, 2, 2) the x_proj
    product's backward (dbc -> xin and the weight's gradient) contracts
    over all 128 channels of d_inner on each rank of "model", where the
    forward and the reference's transpose take the rank's 64: half of
    those products is the fault's ``fd.FAULTS`` entry (PERF.md §6).  When
    the fault is repaired this test changes with it, and its entry
    goes."""
    import fixtures_torch_dryrun as fd
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY["falcon-mamba-7b"].smoke()
    di, r = cfg.d_inner, cfg.dt_rank + 2 * cfg.ssm_state
    T = fd.BATCH // 4 * fd.SEQ                 # the rank's tokens
    dots, _ = fd.products("falcon-mamba-7b")
    whole = {k[3:]: f for k, f in dots.items()
             if k[0] and k[2] == "mm" and k[3:] in (((T, r), (r, di)),
                                                    ((di, T), (T, r)))}
    # d xin's transpose and the weight's gradient, each over all of d_inner
    assert set(whole) == {((T, r), (r, di)), ((di, T), (T, r))}
    assert sum(whole.values()) / 2 == \
        fd.FAULTS["falcon-mamba-7b/train"]["x_proj backward whole"]


def test_no_module_of_the_reference_lacks_a_twin():
    """Listing both packages: every module of ``src/repro`` has a twin
    of the same path in ``src/repro_torch`` but the two whose twins are
    named for what they analyse."""
    renamed = {"analysis/jaxpr_lint.py": "analysis/surface_lint.py",
               "launch/hlo_analysis.py": "launch/step_analysis.py"}
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    for f in ref.rglob("*.py"):
        rel = str(f.relative_to(ref))
        assert (port / renamed.get(rel, rel)).exists(), rel
    assert re.search(r"twin of\s+``repro.launch.hlo_analysis``",
                     (port / "launch" / "step_analysis.py").read_text())
    assert os.path.exists(port / "launch" / "dryrun.py")
