"""The port's dry-run (``launch/dryrun.py``) and logical production
meshes (``launch/mesh.py``).

One reduced cell (reduced qwen3 at the ``train_4k`` shape) runs on
``meta`` on both production meshes, and its record carries the fields
the JAX package's dry-run records carry, computed from the port's own
layout: per-node bytes of parameters, optimizer state and log ring (from
the sharding specs), the step's counted FLOPs and bytes, the
replication traffic (payload x N_r per node), the parameter counts and
the card's roofline. A cell ``shape_applicable`` refuses is recorded as
skipped; the CLI writes one JSON file per cell.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import config as TC
from repro_torch.core.replication import tree_flatten
from repro_torch.distributed.context import P
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_local_mesh, make_mesh,
                                     make_production_mesh)

REDUCED = TC.get_reduced_config("qwen3-0.6b")


@pytest.fixture(scope="module")
def records():
    return {mp: dryrun.run_cell("qwen3-0.6b", "train_4k", mp, save=False,
                                model_cfg=REDUCED)
            for mp in (False, True)}


def test_production_meshes_are_logical_contexts():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert (single.axis_names, single.axis_sizes) == (("data", "model"),
                                                      (16, 16))
    assert (multi.axis_names, multi.axis_sizes) == (
        ("pod", "data", "model"), (2, 16, 16))
    assert multi.batch_axes == ("pod", "data") and multi.model_size == 16
    assert single.device.type == "meta" and multi.device.type == "cpu"
    assert make_mesh(TC.MULTI_POD, device="cpu").shape == multi.shape
    local = make_local_mesh(2, device="cpu")
    assert local.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_local_mesh(3, device="cpu")


def test_reduced_cell_record(records):
    for mp, r in records.items():
        assert r["status"] == "ok", r.get("traceback")
        assert r["mesh"] == ("2x16x16" if mp else "16x16")
        assert r["step"] == "train_step" and r["device"] == "meta"
        assert r["n_nodes"] == (512 if mp else 256)
        assert r["model_params"] == REDUCED.param_count()
        assert r["active_params"] == REDUCED.active_param_count()
        assert r["tokens"] == 4096 * 256
        mem = r["memory"]
        assert set(mem) == {"params_bytes_per_node",
                            "opt_state_bytes_per_node",
                            "log_ring_bytes_per_node"}
        assert all(v > 0 for v in mem.values())
        rep = r["replication"]
        assert rep["ring_axes"] == ["data"] and rep["ring_nodes"] == 16
        assert rep["send_bytes_per_node_per_step"] == \
            TC.ReplicationConfig().n_replicas * rep["payload_bytes_per_node"]
        assert rep["send_bytes_global_per_step"] == \
            rep["send_bytes_per_node_per_step"] * r["n_nodes"]
        c = r["cost"]
        assert c["flops_global"] > 0 and c["bytes_global"] > 0
        assert c["kernel_calls"] == {
            "repro_torch::flash_attention_fwd": 2 * REDUCED.n_layers,
            "repro_torch::flash_attention_bwd": REDUCED.n_layers}
        roof = r["roofline_one_card"]
        assert roof["card"] == "NVIDIA H100 80GB HBM3 / 700 W"
        assert roof["flops_ms"] == pytest.approx(
            c["flops_global"] / 989e12 * 1e3)
        assert roof["bytes_ms"] == pytest.approx(
            c["bytes_global"] / 3.35e12 * 1e3)
        assert r["attention_pair_walks"] == []
        json.dumps(r)
    # the products are the mesh's business only through replication,
    # which has none; every node holds half as much on two pods
    a, b = records[False], records[True]
    assert a["cost"]["flops_global"] == b["cost"]["flops_global"]
    assert b["memory"]["params_bytes_per_node"] < \
        a["memory"]["params_bytes_per_node"]


def test_per_node_bytes_follow_the_specs():
    ctx = make_production_mesh(device="meta")
    tree = {"a": torch.empty(32, 48, device="meta"),
            "b": torch.empty(10, device="meta", dtype=torch.bfloat16),
            "c": torch.empty(20, 16, device="meta")}
    specs = {"a": P("data", "model"), "b": P(None), "c": P("data")}
    # a: 2 x 3 f32; b: whole, 10 bf16; c: 20 rows over 16 nodes pad to
    # 2 rows x 16 f32
    assert dryrun.per_node_bytes(tree, specs, ctx) == \
        2 * 3 * 4 + 10 * 2 + 2 * 16 * 4
    assert len(tree_flatten(specs)[0]) == 3


def test_skipped_cell_is_recorded():
    r = dryrun.run_cell("qwen3-0.6b", "long_500k", False, save=False,
                        model_cfg=REDUCED)
    assert r["status"] == "skipped" and "524288" in r["reason"]


def test_cli_writes_one_record_per_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                      "--mesh", "both", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "dry-run: 2 ok, 0 skipped-by-design, 0 errors" in out
    files = sorted(os.listdir(tmp_path))
    assert files == ["dryrun_qwen3-0.6b_decode_32k_16-16.json",
                     "dryrun_qwen3-0.6b_decode_32k_2-16-16.json"]
    rec = json.load(open(tmp_path / files[0]))
    assert rec["status"] == "ok" and rec["step"] == "serve_step"
    assert rec["replication"] is None
    assert np.isfinite(rec["cost"]["flops_global"])
