"""The port's serving with the ``model`` axis split across
``torch.distributed`` ranks, on the CPU (``gloo``), against the JAX
package on host-device meshes of the same shape.

Two worlds are spawned once for the module (``torch_tp_cases.py``): 2
ranks on a (1 data x 2 model) mesh and 4 on a (2 x 2) one, each rank one
``model`` position of a block of data positions, its parameters placed
by their specs (FSDP over ``data``, tensor parallel over ``model``, the
MoE's EP / TP). Each serves ten reduced f32 configs (whisper's encoder,
decoder and cross-attention among them) at a batch of 4 -- the JAX
package's own weights through ``params_from_jax`` -- with
``make_serve_fns``: the prefill and 3 greedy decode steps; and qwen3,
hymba, moonshot and whisper at a batch of one row, which the data
blocks do not divide: every rank serves the row, and its KV caches hold
its block's span of the sequence (``sharding.cache_span``). Against the
JAX package's ``make_serve_fns`` jitted on ``make_mesh((1, 2))`` /
``make_mesh((2, 2))`` over the conftest's host devices (its parameters
placed with its ``named_shardings``, a one-row cache placed by its
``cache_specs`` before the decode, as its dry-run places it):

* the prefill's logits at every position and each decode step's within
  1e-4 of max |logit|, the tokens ``==``; for one row also with the
  prompt straddling the blocks' spans, with block 1 left empty, and
  with a cache length the blocks do not divide (45: each keeps the
  whole cache);
* a rank's one-row ``k`` / ``v`` / ``cross_k`` / ``cross_v`` bytes the
  reference's shard on the same mesh position, and the one-card cache's
  bytes at the rank's heads over the blocks;
* the MoE configs routed as the reference's ``shard_map`` routes (each
  data block on its own); near a router tie the two packages could rank
  other experts (ROADMAP C2), so each MoE run's smallest top-k margin is
  read beside it and must stay above ``MIN_MARGIN``, about 100 times the
  two packages' f32 distance in the router's probabilities (~1e-7,
  ``test_torch_moe.py``);
* every planted fault -- ``wo``'s sum skipped, the gated norm's sum of
  squares skipped, ``e_start = 0`` on every rank, the vocab mask dropped,
  whisper's cross-attention sum skipped; and where the sequence is
  split, the blocks' merge skipped, the empty block's guard dropped (NaN)
  and the new K/V row written in every block -- fails that check;
* an uneven world and the wrong backend raise ``ValueError``; a batch
  the data blocks do not divide is served whole, its tokens ``==`` the
  reference's;
* each rank's init blocks are ``==`` the one-card init's slices.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_cases as cases
from repro import config as JC
from repro.distributed.context import MeshContext as JContext
from repro.distributed.context import make_context as jax_make_context
from repro.distributed.context import make_mesh, mesh_context
from repro.distributed.sharding import batch_specs as jax_batch_specs
from repro.distributed.sharding import cache_specs as jax_cache_specs
from repro.distributed.sharding import named_shardings as jax_shardings
from jax.sharding import NamedSharding
from repro.models import build_model as jax_build_model
from repro.training import steps as jsteps
from repro_torch.distributed import sharding
from repro_torch.distributed.context import make_context

WORLDS = (2, 4)
#: every (case, world) served: the CONFIGS at both worlds, the ONE_ROW
#: cases at both but those only 2 blocks tell apart
SERVED = [(n, w) for n in list(cases.CONFIGS) + list(cases.ONE_ROW)
          for w in WORLDS if w == 4 or n not in cases.SPLIT_ONLY]
LOGIT_TOL = 1e-4
MIN_MARGIN = 1e-5
MOE = ("moonshot", "moonshot_e3", "moonshot_e3_odd")


def _with_logits(model):
    """The JAX model with each prefill's and decode step's logits kept in
    the cache, so the jitted serve fns return them."""
    def prefill(p, b, **kw):
        logits, cache = model.prefill(p, b, **kw)
        return logits, {**cache, "logits": logits}

    def decode_step(p, c, t):
        logits, cache = model.decode_step(
            p, {k: v for k, v in c.items() if k != "logits"}, t)
        return logits, {**cache, "logits": logits}

    return dataclasses.replace(model, prefill=prefill,
                               decode_step=decode_step)


CACHE_KV = ("k", "v", "cross_k", "cross_v")


def _jax_serve(name, tree, world, batch=None, decode=True):
    """The JAX package's ``make_serve_fns`` jitted on a mesh of the
    world's shape: (prefill logits, [decode logits], tokens, the K/V
    caches' bytes). A one-row cache is placed by ``cache_specs`` before
    the decode (``src/repro/launch/dryrun.py:188-196``); its bytes are
    ``{leaf: (global, {(data, model): shard bytes})}``."""
    shape = cases.MESHES[world]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:world])
    jcfg = cases.config(name, JC)
    rows, max_len = cases.serve_shape(name)
    if batch is None:
        batch = cases.batch_data(name)
    run = JC.RunConfig(
        model=jcfg, shape=JC.ShapeConfig("serve", seq_len=cases.PROMPT,
                                         global_batch=rows,
                                         kind="prefill"),
        mesh=JC.MeshConfig(shape, ("data", "model")))
    prefill_fn, decode_fn = jsteps.make_serve_fns(
        run, _with_logits(jax_build_model(jcfg)))
    ctx = jax_make_context(mesh)
    nbytes = {}
    with mesh_context(ctx):
        params = jax.tree.map(jnp.asarray, tree)
        params = jax.tree.map(jax.device_put, params,
                              jax_shardings(params, jcfg, ctx))
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        toks, st = jax.jit(
            lambda p, b: prefill_fn(p, b, max_len=max_len))(params, batch)
        pre = np.asarray(st.cache["logits"])
        out, dec = [np.asarray(toks)], []
        if name in cases.ONE_ROW:
            cache = {k: v for k, v in st.cache.items() if k != "logits"}
            specs = jax_cache_specs(cache, jcfg, ctx)
            cache = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                     for k, v in cache.items()}
            st = st._replace(cache={**cache, "logits": st.cache["logits"]})
            where = {d: tuple(int(i) for i in
                               np.argwhere(mesh.devices == d)[0])
                     for d in mesh.devices.flat}
            nbytes = {k: (cache[k].nbytes,
                          {where[sh.device]: sh.data.nbytes
                           for sh in cache[k].addressable_shards})
                      for k in CACHE_KV if k in cache}
        step = jax.jit(decode_fn)
        for _ in range(cases.N_DECODE if decode else 0):
            toks, st = step(params, st)
            out.append(np.asarray(toks))
            dec.append(np.asarray(st.cache["logits"]))
    return pre, dec, np.stack(out, axis=1), nbytes


@pytest.fixture(scope="module")
def runs():
    """Both worlds, spawned together; the JAX references are computed
    while they run."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 host devices")
    trees = {name: jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        jax_build_model(cases.config(name, JC)).init(
            jax.random.PRNGKey(cases.SEED)))
        for name in cases.CONFIGS}
    root = tempfile.mkdtemp()
    try:
        handles = {}
        for w in WORLDS:
            os.makedirs(os.path.join(root, f"w{w}"))
            handles[w] = cases.start(w, os.path.join(root, f"w{w}"), trees)
        ref = {(name, w): _jax_serve(name, trees[cases.config_of(name)], w)
               for name, w in SERVED}
        ref[("batch_not_divided", 4)] = _jax_serve(
            "qwen3", trees["qwen3"], 4, decode=False,
            batch={"tokens": np.zeros(cases.UNDIVIDED, np.int32)})
        got = {w: cases.finish(h, w, os.path.join(root, f"w{w}"))
               for w, h in handles.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ref, got


def _assemble(ranks, name, key="serve", case=None):
    """The global prefill logits, decode logits and tokens from each
    block's model-position-0 rank, as a list of views of the batch: one
    view, the blocks' rows joined, where the blocks split the batch; one
    view a block where each serves the whole batch. Every rank of a
    block must hold the same gathered logits and tokens. ``case``: the
    CONFIGS or ONE_ROW name served (``name`` unless a fault's)."""
    blocks = {}
    for r in ranks:
        rec = r[key][name]
        first = blocks.setdefault(r["block"], rec)
        assert np.array_equal(first["prefill"], rec["prefill"],
                              equal_nan=True)
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in
                   zip(first["decode"], rec["decode"]))
        assert np.array_equal(first["tokens"], rec["tokens"])
    order = [blocks[b] for b in sorted(blocks)]
    rows = cases.serve_shape(case or name)[0]
    if all(tuple(c["rows"]) == (0, rows) for c in order):
        return [(c["prefill"], c["decode"], c["tokens"]) for c in order]
    assert [c["rows"][0] for c in order] == \
        list(range(0, rows, rows // len(order)))
    return [(np.concatenate([c["prefill"] for c in order]),
             [np.concatenate([c["decode"][t] for c in order])
              for t in range(cases.N_DECODE)],
             np.concatenate([c["tokens"] for c in order]))]


def _errors(got, want):
    """Each compared logit array's max |diff| over its max |logit|."""
    pre, dec, _ = got
    wpre, wdec = want[:2]
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip([pre] + dec, [wpre] + wdec)]


def _within(views, want) -> bool:
    """Whether every view's logits are within ``LOGIT_TOL`` (a NaN is
    not)."""
    return all(e <= LOGIT_TOL for v in views for e in _errors(v, want))


def _check_served(got, ref, world, name):
    views = _assemble(got[world], name)
    want = ref[(name, world)]
    for port in views:
        errs = _errors(port, want)
        assert max(errs) <= LOGIT_TOL, errs
        assert np.array_equal(port[2], want[2])


@pytest.mark.parametrize("name", list(cases.CONFIGS))
@pytest.mark.parametrize("world", WORLDS)
def test_serve_matches_jax_on_a_mesh(runs, world, name):
    ref, got = runs
    _check_served(got, ref, world, name)
    if name in MOE:
        margin = min(r["serve"][name]["margin"] for r in got[world])
        assert margin >= MIN_MARGIN, margin


@pytest.mark.parametrize("world,name", [
    (w, n) for w in WORLDS for n in cases.ONE_ROW
    if w == 4 or n not in cases.SPLIT_ONLY])
def test_one_row_matches_jax_on_a_mesh(runs, world, name):
    """A batch of one row: served whole on every rank, its caches split
    on the sequence over the blocks at world 4 (the prompt straddling
    them, block 1 empty, or a length they do not divide)."""
    ref, got = runs
    _check_served(got, ref, world, name)
    if cases.config_of(name) in MOE:
        margin = min(r["serve"][name]["margin"] for r in got[world])
        assert margin >= MIN_MARGIN, margin


@pytest.mark.parametrize("fault", [f for f in cases.FAULTS
                                   if f not in cases.SPLIT_FAULTS])
@pytest.mark.parametrize("world", WORLDS)
def test_planted_fault_fails_the_check(runs, world, fault):
    ref, got = runs
    name = cases.FAULTS[fault]
    views = _assemble(got[world], fault, key="faults", case=name)
    assert not _within(views, ref[(name, world)])


@pytest.mark.parametrize("fault", cases.SPLIT_FAULTS)
def test_split_cache_fault_fails_the_check(runs, fault):
    """The faults in the sequence split, at world 4 (2 blocks): the merge
    skipped (each block's own softmax), the empty block's guard dropped
    (NaN), the new K/V row written in every block."""
    ref, got = runs
    name = cases.FAULTS[fault]
    views = _assemble(got[4], fault, key="faults", case=name)
    assert not _within(views, ref[(name, 4)])


@pytest.mark.parametrize("name", ["qwen3_b1", "hymba_b1", "moonshot_b1",
                                  "whisper_b1", "qwen3_b1_empty",
                                  "qwen3_b1_uneven"])
def test_one_rank_holds_its_span_of_the_cache(runs, name):
    """At world 4 a rank's one-row ``k`` / ``v`` (and ``cross_k`` /
    ``cross_v``) bytes are the reference's shard at the same (data,
    model) position, and the one-card cache's bytes at the rank's heads
    over the 2 blocks -- or all of them where the blocks do not divide
    the length (45)."""
    ref, got = runs
    nbytes = ref[(name, 4)][3]
    cfg = cases.config(name)
    assert set(nbytes) == ({"k", "v", "cross_k", "cross_v"}
                           if cfg.is_encdec else {"k", "v"})
    length = cases.serve_shape(name)[1]
    for r in got[4]:
        for leaf, (whole, shards) in nbytes.items():
            mine = r["serve"][name]["bytes"][leaf]
            assert mine == shards[(r["block"], r["model_rank"])]
            heads = cfg.n_kv_heads if cfg.n_kv_heads % 2 else \
                cfg.n_kv_heads // 2
            at_heads = whole * heads // cfg.n_kv_heads
            span = cfg.n_frames if leaf.startswith("cross") else length
            assert mine == (at_heads // 2 if span % 2 == 0 else at_heads)


def test_attention_merge_is_counted(runs):
    """At world 4 a one-row decode step merges each layer's
    self-attention (and whisper's cross-attention) once over the
    blocks; a prefill, a divided batch and an undivided length merge
    nothing."""
    _, got = runs
    for r in got[4]:
        c = {n: r["serve"][n]["counts"] for n in
             ("qwen3", "qwen3_b1", "whisper_b1", "qwen3_b1_uneven")}
        assert c["qwen3_b1"]["decode"]["attn_merge"] == 2 * cases.N_DECODE
        assert c["whisper_b1"]["decode"]["attn_merge"] == \
            2 * 2 * cases.N_DECODE
        assert all(v["prefill"]["attn_merge"] == 0 for v in c.values())
        assert c["qwen3"]["decode"]["attn_merge"] == 0
        assert c["qwen3_b1_uneven"]["decode"]["attn_merge"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise(runs, world):
    """An uneven world and the wrong backend raise; a batch of 3 rows,
    which 2 data blocks do not divide, is served whole on every rank,
    its tokens ``==`` the reference's."""
    ref, got = runs
    want = {"uneven_world": "ValueError", "wrong_backend": "ValueError"}
    if world == 4:
        want["batch_not_divided"] = "none"
    for r in got[world]:
        toks = r["refusals"].pop("batch_not_divided_tokens", None)
        assert r["refusals"] == want
        if world == 4:
            assert np.array_equal(toks, ref[("batch_not_divided", 4)][2][:, 0])


@pytest.mark.parametrize("world", WORLDS)
def test_init_blocks_equal_the_one_card_slices(runs, world):
    _, got = runs
    for r in got[world]:
        assert r["blocks"] == {n: True for n in cases.BLOCK_CONFIGS}
        assert not r["jax_imported"]


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_are_counted(runs, world):
    """qwen3 (2 layers): a prefill sums the embedding, then each layer's
    ``wo`` and ``w_down`` partials, over ``model`` (5 calls) and gathers
    the last logits once; each decode step the same; FSDP gathers only
    where the data axis stores a dimension (world 4)."""
    _, got = runs
    for r in got[world]:
        c = r["serve"]["qwen3"]["counts"]
        assert c["prefill"]["model_sum"] == 5
        assert c["prefill"]["model_gather"] == 1
        assert c["decode"]["model_sum"] == 5 * cases.N_DECODE
        assert c["decode"]["model_gather"] == cases.N_DECODE
        if world == 2:
            assert c["prefill"]["fsdp_gather"] == 0
        else:
            assert c["prefill"]["fsdp_gather"] > 0
            assert c["decode"]["fsdp_gather"] == \
                cases.N_DECODE * c["prefill"]["fsdp_gather"]


def _stand_in_jax_ctx(shape):
    names = ("data", "model")
    mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    return JContext(mesh=mesh, batch_axes=("data",), model_axis="model",
                    fsdp_axes=("data",))


def _entry_axes(spec, dim):
    e = spec[dim] if dim < len(spec) else None
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 4), (8, 1)])
def test_cache_and_batch_specs_match_jax(shape):
    """The port's batch split (``sharding.batch_blocks``) is the JAX
    rules' ``batch_specs`` split for every batch of 1-8 rows; and the
    reference's ``cache_specs`` is the storage rule ROADMAP's "split serve
    caches" contract states, which the port's caches depart from: KV
    heads over ``model`` only when ``m`` divides them, the conv cache's
    channels over ``model`` as one block, SSD heads over ``model`` when
    divisible, and the sequence split where the data axes do not divide
    the batch. The rules read only axis sizes."""
    ctx = make_context(shape, ("data", "model"), device="cpu")
    jctx = _stand_in_jax_ctx(shape)
    nb, m = shape
    for b in range(1, 9):
        spec = jax_batch_specs({"tokens": np.zeros((b, 8))}, jctx)["tokens"]
        assert sharding.batch_blocks(b, ctx) == int(np.prod(
            [dict(zip(("data", "model"), shape))[a]
             for a in _entry_axes(spec, 0)]))
    for b in (4, 1):
        cache = {"k": np.zeros((2, b, 16, 4, 8)),
                 "v": np.zeros((2, b, 16, 2, 8)),
                 "cross_k": np.zeros((2, b, 6, 3, 8)),
                 "conv": np.zeros((2, b, 3, 40)),
                 "ssd": np.zeros((2, b, 6, 4, 8)),
                 "length": np.zeros(())}
        want = jax_cache_specs(cache, None, jctx)
        split_batch = b % nb == 0
        for name in ("k", "v"):
            heads = cache[name].shape[3]
            assert _entry_axes(want[name], 3) == (
                ("model",) if heads % m == 0 else ())
            assert _entry_axes(want[name], 1 if split_batch else 2) == \
                ("data",)
            assert _entry_axes(want[name], 2 if split_batch else 1) == ()
        assert _entry_axes(want["cross_k"], 3) == (
            ("model",) if 3 % m == 0 else ())
        assert _entry_axes(want["conv"], 3) == ("model",)
        assert _entry_axes(want["ssd"], 2) == (
            ("model",) if 6 % m == 0 else ())
        assert tuple(want["length"]) == ()


def test_serve_launcher_under_torchrun(tmp_path):
    """``launch/serve.py --mesh 1x2`` under ``torch.distributed.run`` on
    2 CPU ranks: rank 0 prints one summary and sequence 0's tokens."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--arch", "qwen3-0.6b", "--reduced", "--mesh", "1x2",
         "--prompt-len", "16", "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    summaries = [l for l in lines if l.startswith("qwen3-0.6b-reduced:")]
    samples = [l for l in lines if l.startswith("sample generation")]
    assert len(summaries) == 1 and "on a 1x2 mesh, 2 ranks" in summaries[0]
    assert len(samples) == 1
    toks = eval(samples[0].split(":", 1)[1])        # a printed list
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


def test_serve_launcher_serves_whisper_one_row_under_torchrun(tmp_path):
    """``launch/serve.py --arch whisper-medium --mesh 2x2 --batch 1``
    under ``torch.distributed.run`` on 4 CPU ranks: the enc-dec model and
    a batch the 2 data positions do not divide, each rank serving the row
    over its span of the cache; rank 0 prints the one-process run's
    tokens."""
    from repro_torch.launch import serve as serve_mod
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    args = ["--arch", "whisper-medium", "--reduced", "--batch", "1",
            "--prompt-len", "16", "--gen", "4", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
         "--mesh", "2x2", *args],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    summaries = [l for l in lines
                 if l.startswith("whisper-medium-reduced:")]
    samples = [l for l in lines if l.startswith("sample generation")]
    assert len(summaries) == 1 and "on a 2x2 mesh, 4 ranks" in summaries[0]
    assert "prefill 1x16" in summaries[0] and len(samples) == 1
    toks = eval(samples[0].split(":", 1)[1])        # a printed list
    one = serve_mod.serve("whisper-medium", reduced=True, batch=1,
                          prompt_len=16, gen=4, device="cpu")
    assert toks == one.tokens[0].tolist()
