"""The port's measured autotuner (``repro_torch.ops.autotune``) and its
``TuningCache`` (``repro_torch.ops.tiling``) against the JAX package's,
on the CPU.

Pins what can be checked without a card, in the reference's four groups
(``tests/test_autotune.py``):

  * persistence — versioned JSON rows of the reference's shape; corrupt,
    unknown-version and malformed files warn and load nothing;
  * scoping — entries are keyed by platform (the card's name and compute
    capability, ``"cpu"`` here): tiles measured elsewhere never steer a
    launch; the resolution order is overrides > cache > heuristic, for
    the conv template, ``qmatmul`` and the stream's ``th`` (the last held
    against the reference's ``resolve_tile_rows``);
  * search — coordinate descent with 5% hysteresis picks what the
    reference's picks on the same measured costs; CPU dispatch tunes
    nothing (tiles bind only on the ``cuda`` backend with a CUDA tensor);
  * plans — a seeded cache is baked into ``BoundPlan.tuned`` for the
    stages the reference bakes (2 fused stages, +1 ``qmatmul`` under
    int8), a persisted cache skips measurement, and pinning reverts a
    bad winner. A baked plan's logits stay within the port's bars of the
    JAX plan: int8 bitwise, qformat one step, fp32 1e-5.

Measuring real launches, and tuned against heuristic plans on the card,
is ``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s ``boot`` phase.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops.autotune as j_autotune
import repro_torch.ops.autotune as autotune
from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
from repro.ops import TUNING_CACHE as J_CACHE
from repro.ops import TuningCache as JTuningCache
from repro.stream.executor import resolve_tile_rows as j_resolve_tile_rows
from repro.stream.tiling import SpatialTiling as JSpatialTiling
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.fused_cwp import ops as fc_ops
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.ops import (TUNING_CACHE, ExecPolicy, TuningCache,
                             ensure_tuned, resolved_backend)
from repro_torch.ops import tiling
from repro_torch.ops.tiling import SCHEMA_VERSION, conv_signature
from repro_torch.stream import SpatialTiling, resolve_tile_rows

CARD = "NVIDIA H100 80GB HBM3 sm_90"
SIG1 = (4, 1, 28, 28, 15, 3, 3, 1, 1)       # the batch-4 plan's stages
SIG2 = (4, 15, 13, 13, 20, 6, 6, 1, 1)
TOL_FP32 = 1e-5
QSTEP = 2.0 ** -8
rng = np.random.RandomState(0)
X = torch.from_numpy(rng.randn(5, 3, 12, 12).astype(np.float32))
W = torch.from_numpy(rng.randn(8, 3, 3, 3).astype(np.float32))
B = torch.from_numpy(rng.randn(8).astype(np.float32))


@pytest.fixture(autouse=True)
def _isolated_caches(monkeypatch):
    """Each test sees empty global caches in both packages, and a tuner
    that must not measure; whatever it stores is discarded afterwards."""
    saved, jsaved = TUNING_CACHE.snapshot(), J_CACHE.snapshot()
    TUNING_CACHE.clear()
    J_CACHE.clear()

    def refuse(*_, **__):
        raise AssertionError("the tuner measured on the CPU")

    monkeypatch.setattr(autotune, "_measure", refuse)
    yield
    TUNING_CACHE.restore(saved)
    J_CACHE.restore(jsaved)


@pytest.fixture(scope="module")
def weights():
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(0))
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")


# ---------------------------------------------------------- persistence

class TestPersistence:
    def test_roundtrip_in_the_reference_row_format(self, tmp_path):
        cache = TuningCache()
        cache.put("fused_conv_block", SIG1, torch.float32,
                  {"threads": 128, "cpb": 8, "band": 2, "split": 4,
                   "ipb": 2})
        cache.put("qmatmul", (64, 32, 16), torch.int8,
                  {"body": 0, "tile_m": 8, "tile_n": 16, "ksplit": 8},
                  platform=CARD)
        path = tmp_path / "cache.json"
        cache.save(path)
        jcache = JTuningCache()
        jcache.put("fused_conv_block", SIG1, jnp.float32, {"pb": 2})
        jpath = tmp_path / "jcache.json"
        jcache.save(jpath)
        doc, jdoc = (json.loads(p.read_text()) for p in (path, jpath))
        assert doc["version"] == SCHEMA_VERSION == jdoc["version"]
        assert set(doc) == set(jdoc)
        assert {frozenset(r) for r in doc["entries"]} == \
            {frozenset(r) for r in jdoc["entries"]}
        assert {r["platform"] for r in doc["entries"]} == {"cpu", CARD}
        assert doc["entries"][0]["dtype"] == jdoc["entries"][0]["dtype"]

        fresh = TuningCache()
        assert fresh.load(path) == 2
        assert fresh.get("fused_conv_block", SIG1, torch.float32) == \
            cache.get("fused_conv_block", SIG1, torch.float32)
        assert fresh.get("qmatmul", (64, 32, 16), torch.int8,
                         platform=CARD)["ksplit"] == 8
        assert fresh.export_rows() == cache.export_rows()

    @pytest.mark.parametrize("text,match", [
        ("{not json at all", "corrupt"),
        (json.dumps({"version": SCHEMA_VERSION + 999,
                     "entries": [{"op": "conv2d"}]}),
         "unknown schema version")])
    def test_bad_file_warns_and_loads_nothing_like_the_reference(
            self, tmp_path, text, match):
        path = tmp_path / "bad.json"
        path.write_text(text)
        for cls in (TuningCache, JTuningCache):
            cache = cls()
            with pytest.warns(UserWarning, match=match):
                assert cache.load(path) == 0
            assert len(cache) == 0

    def test_list_format_and_malformed_rows(self, tmp_path):
        """The reference's pre-versioned list format never existed for the
        port: it warns and loads nothing. A malformed row is skipped with a
        warning and its well-formed neighbours load, as in the reference."""
        path = tmp_path / "legacy.json"
        path.write_text(json.dumps([{"op": "qmatmul", "shape": [1, 4, 1],
                                     "dtype": "int8", "params": {}}]))
        with pytest.warns(UserWarning, match="expected a JSON object"):
            assert TuningCache().load(path) == 0
        rows = [{"op": "qmatmul", "shape": [1, 4, 1], "dtype": "int8",
                 "params": {"rows": 4}}, {"op": "qmatmul", "shape": [2]}]
        path.write_text(json.dumps({"version": SCHEMA_VERSION,
                                    "entries": rows}))
        for cls in (TuningCache, JTuningCache):
            with pytest.warns(UserWarning, match="malformed"):
                assert cls().load(path) == 1

    def test_heuristics_survive_corrupt_cache(self, tmp_path):
        path = tmp_path / "corrupt.json"
        path.write_text("]")
        want = tiling.fused_tiles(*SIG1, platform="cpu")
        with pytest.warns(UserWarning):
            TUNING_CACHE.load(path)
        assert tiling.fused_tiles(*SIG1, platform="cpu") == want
        out = fc_ops.fused_cwp(X, W, B)
        torch.testing.assert_close(out, fc_ops.fused_cwp(X, W, B),
                                   rtol=0, atol=0)


# ---------------------------------------------------- cache key scoping

class TestCacheScoping:
    def test_platform_scoped_entries(self):
        TUNING_CACHE.put("fused_conv_block", SIG1, torch.float32,
                         {"split": 32, "band": 1}, platform=CARD)
        assert TUNING_CACHE.get("fused_conv_block", SIG1,
                                torch.float32) is None
        heur = tiling.choose_fused_blocks(*SIG1)
        here = tiling.fused_tiles(*SIG1, platform="cpu")
        there = tiling.fused_tiles(*SIG1, platform=CARD)
        assert here["split"] == heur["split"]
        assert (there["split"], there["band"]) == (32, 1)
        assert tiling.platform_key() == tiling.platform_key("cpu") == "cpu"

    def test_resolution_order_overrides_cache_heuristic(self):
        TUNING_CACHE.put("fused_conv_block", SIG1, torch.float32,
                         {"cpb": 16, "ipb": 3})
        TUNING_CACHE.put("qmatmul", (8, 320, 10), torch.int8,
                         {"tile_m": 4, "ksplit": 16})
        t = tiling.fused_tiles(*SIG1, {"fused_conv_block.ipb": 2},
                               platform="cpu")
        assert (t["cpb"], t["ipb"]) == (16, 2)
        assert t["band"] == tiling.choose_fused_blocks(*SIG1)["band"]
        # the cache entry of one op never steers the other of the template
        conv = tiling.fused_tiles(*SIG1, pool=False, platform="cpu")
        assert conv["cpb"] == tiling.choose_fused_blocks(
            *SIG1, pool=False)["cpb"]
        q = tiling.qmatmul_tiles(8, 320, 10, {"tile_m": 16}, platform="cpu")
        assert (q["tile_m"], q["ksplit"], q["splits"]) == (16, 16, 20)

    @pytest.mark.parametrize("op,fused", [("stream_conv2d", False),
                                          ("stream_fused_conv_block", True)])
    def test_stream_th_resolves_like_the_reference(self, op, fused):
        """Policy > cache row > the SpatialTiling's default, for the same
        rows and overrides in both packages."""
        x, w = torch.zeros(2, 3, 40, 20), torch.zeros(4, 3, 3, 3)
        jx, jw = jnp.zeros(x.shape), jnp.zeros(w.shape)
        spec = SpatialTiling(6, 2, pooled=fused)
        jspec = JSpatialTiling(6, 2, pooled=fused)
        sig = conv_signature(x.shape, w.shape, (1, 1))
        cases = [({}, None), ({}, 4), ({f"{op}.th": 3}, 4),
                 ({"th": 5}, None)]
        for overrides, cached in cases:
            TUNING_CACHE.clear()
            J_CACHE.clear()
            if cached is not None:
                TUNING_CACHE.put(op, sig, torch.float32, {"th": cached})
                J_CACHE.put(op, sig, jnp.float32, {"th": cached})
            got = resolve_tile_rows(op, x, w, (1, 1), spec,
                                    ExecPolicy(tiling=overrides))
            want = j_resolve_tile_rows(op, jx, jw, (1, 1), jspec,
                                       JPolicy(tiling=overrides))
            assert got == want, (overrides, cached)


# --------------------------------------------------------------- search

class TestSearch:
    def test_cpu_dispatch_tunes_nothing(self):
        """Tiles bind only on the cuda backend with a CUDA tensor: every
        CPU call returns None without measuring, whichever backend the
        policy names, as the reference's non-pallas dispatch does."""
        q = ExecPolicy(quant="int8")
        xc = torch.ones(4, 320, dtype=torch.int8)
        wc = torch.ones(320, 10, dtype=torch.int8)
        for pol in (None, ExecPolicy(backend="cuda"), q):
            assert ensure_tuned("conv2d", X, W, None, stride=(1, 1),
                                policy=pol) is None
            assert ensure_tuned("fused_conv_block", X, W, B, stride=(1, 1),
                                odd="raise", scale=None, policy=pol) is None
            assert ensure_tuned("qmatmul", xc, wc, torch.ones(4, 1),
                                torch.ones(1, 10), policy=pol) is None
        assert ensure_tuned("tree_reduce_sum", X) is None
        assert len(TUNING_CACHE) == 0
        assert j_autotune.ensure_tuned("conv2d", jnp.asarray(X.numpy()),
                                       jnp.asarray(W.numpy()), None,
                                       stride=(1, 1)) is None
        fc_ops.fused_cwp(X, W, B, policy=ExecPolicy(autotune=True))
        assert len(TUNING_CACHE) == 0

    def test_cache_hit_is_returned(self):
        sig = conv_signature(X.shape, W.shape, (1, 1))
        TUNING_CACHE.put("conv2d", sig, torch.float32, {"split": 2})
        assert ensure_tuned("conv2d", X, W, None, stride=(1, 1)) == \
            {"split": 2}

    def test_resolved_backend(self):
        assert resolved_backend("fused_conv_block", X, W, B) == "torch"
        assert resolved_backend("fused_conv_block", X, W, B,
                                policy=ExecPolicy(backend="cuda")) == "cuda"
        assert resolved_backend("fused_conv_block", X.double(), W.double(),
                                policy=ExecPolicy(backend="cuda")) is None

    @pytest.mark.parametrize("gain", [0.03, 0.10])
    def test_descend_picks_what_the_reference_picks(self, monkeypatch,
                                                    gain):
        """Coordinate descent with the 5% hysteresis on the same measured
        costs: a 3% better point never displaces the start, a 10% one
        does, and both packages end on the same point."""
        def cost(a, b):
            return 100.0 * (1 - gain * (a == 4)) * (1 - gain * (b == 1))

        axes = {"a": [1, 2, 4], "b": [1, 2]}
        start = {"a": 2, "b": 2}
        picks = []
        for mod in (autotune, j_autotune):
            monkeypatch.setattr(mod, "_measure", lambda fn, **_: fn())
            picks.append(mod._descend(
                axes, start, lambda **t: lambda: cost(t["a"], t["b"])))
        assert picks[0] == picks[1] == (
            start if gain < autotune.MIN_GAIN else {"a": 4, "b": 1})
        assert autotune.MIN_GAIN == j_autotune.MIN_GAIN == 0.05

    def test_heuristic_tiles(self):
        heur = autotune.heuristic_tiles("fused_conv_block", X, W, B,
                                        stride=(1, 1), odd="pad")
        full = tiling.choose_fused_blocks(5, 3, 12, 12, 8, 3, 3, 1, 1,
                                          odd="pad")
        assert heur == {k: full[k] for k in heur} and set(heur) == {
            "threads", "cpb", "band", "split", "ipb"}
        xc = torch.ones(4, 320, dtype=torch.int8)
        assert autotune.heuristic_tiles(
            "qmatmul", xc, torch.ones(320, 10, dtype=torch.int8)) == \
            tiling.choose_qmatmul_blocks(4, 320, 10)
        assert autotune.heuristic_tiles(
            "stream_conv2d", X, W, tiling=SpatialTiling(7, 2)) == {"th": 7}
        assert autotune.heuristic_tiles("tree_reduce_sum", X) is None


    def test_conv_search_sweeps_every_axis(self, monkeypatch):
        """The conv template's five keys are all swept from the heuristic
        (its point among the candidates), each candidate runs the kernel's
        wrapper with its tiles as overrides, and a scripted winner off the
        heuristic lands in the cache under this platform."""
        seen = {k: set() for k in ("ipb", "band", "cpb", "split",
                                   "threads")}
        last = {}
        real = autotune._with_tiles

        def with_tiles(pol, op, tiles):
            last.clear()
            last.update(tiles)
            for k, v in tiles.items():
                seen[k].add(v)
            return real(pol, op, tiles)

        def measure(fn, **_):
            fn()                        # the plain version on the CPU
            return 50.0 if last["cpb"] == 8 else 100.0

        monkeypatch.setattr(autotune, "_with_tiles", with_tiles)
        monkeypatch.setattr(autotune, "_measure", measure)
        heur = autotune.heuristic_tiles("fused_conv_block", X, W, B,
                                        stride=(1, 1))
        best = autotune.tune_fused_conv_block(X, W, B, stride=(1, 1))
        assert all(len(v) > 1 for v in seen.values()), seen
        assert all(heur[k] in seen[k] for k in seen)
        assert heur["cpb"] != 8 and best["cpb"] == 8
        sig = conv_signature(X.shape, W.shape, (1, 1))
        assert TUNING_CACHE.get("fused_conv_block", sig, torch.float32,
                                "cpu") == best


    def test_qmatmul_search_takes_the_faster_body(self, monkeypatch):
        """Both bodies' heuristics are measured; the other body's, 50%
        faster here, starts the descent, whose axes are that body's own,
        and the winner (that body's keys) lands in the cache."""
        seen = []
        real = autotune._with_tiles

        def with_tiles(pol, op, tiles):
            seen.append(dict(tiles))
            return real(pol, op, tiles)

        def measure(fn, **_):
            fn()                        # the plain version on the CPU
            return 50.0 if seen[-1]["body"] == 1 else 100.0

        monkeypatch.setattr(autotune, "_with_tiles", with_tiles)
        monkeypatch.setattr(autotune, "_measure", measure)
        xc = torch.ones(4, 320, dtype=torch.int8)
        wc = torch.ones(320, 10, dtype=torch.int8)
        heur = autotune.heuristic_tiles("qmatmul", xc, wc)
        best = autotune.tune_qmatmul(xc, wc, torch.ones(4, 1),
                                     torch.ones(1, 10))
        assert heur["body"] == 0 and best["body"] == 1
        assert set(best) == {"body", "tile_m", "ksplit"}
        assert all(set(p) == set(best) for p in seen[2:])
        assert {p["tile_m"] for p in seen[2:]} == {64, 128}
        assert TUNING_CACHE.get("qmatmul", (4, 320, 10), torch.int8,
                                "cpu") == best

    def test_descend_never_measures_a_refused_point(self, monkeypatch):
        monkeypatch.setattr(autotune, "_measure", lambda fn, **_: fn())
        costs = {1: 100.0, 2: 90.0, 3: 10.0}
        best = autotune._descend(
            {"a": [1, 2, 3]}, {"a": 1},
            lambda a: None if a == 3 else (lambda: costs[a]))
        assert best == {"a": 2}

    def test_cached_qmatmul_body_steers_and_the_other_body_misses(self):
        """A tuned entry of the streaming body steers a shape whose
        heuristic is the tensor-core body (its ``tile_n`` is a key of the
        op, not of the heuristic's body); under an overridden body the
        other body's entry is a miss, never a mix of the two."""
        TUNING_CACHE.put("qmatmul", (64, 1024, 2816), torch.int8,
                         {"body": 0, "tile_m": 16, "tile_n": 64,
                          "ksplit": 256}, platform="cpu")
        assert tiling.qmatmul_body(64, 1024, 2816) == 1
        t = tiling.qmatmul_tiles(64, 1024, 2816, platform="cpu")
        assert (t["body"], t["tile_m"], t["tile_n"], t["ksplit"]) == \
            (0, 16, 64, 256)
        t = tiling.qmatmul_tiles(64, 1024, 2816, {"qmatmul.body": 1},
                                 platform="cpu")
        heur = tiling.choose_qmatmul_blocks(64, 1024, 2816, 1)
        assert {k: t[k] for k in heur} == heur and "tile_n" not in t
        TUNING_CACHE.put("qmatmul", (64, 1024, 2816), torch.int8,
                         {"body": 1, "tile_m": 128, "ksplit": 128},
                         platform="cpu")
        t = tiling.qmatmul_tiles(64, 1024, 2816, {"qmatmul.body": 0},
                                 platform="cpu")
        heur = tiling.choose_qmatmul_blocks(64, 1024, 2816, 0)
        assert {k: t[k] for k in heur} == heur

    def test_stale_qmatmul_entry_is_a_miss(self, tmp_path):
        """An entry in the launch keys of an older qmatmul (threads, rows,
        cols, kslice) loads without error and steers nothing: the tiles
        are the heuristic's, and ``ensure_tuned`` does not return it."""
        old = {"threads": 256, "rows": 4, "cols": 16, "kslice": 20}
        path = tmp_path / "old.json"
        path.write_text(json.dumps({
            "version": SCHEMA_VERSION,
            "entries": [{"op": "qmatmul", "shape": [4, 320, 10],
                         "dtype": "int8", "platform": "cpu",
                         "params": old}]}))
        assert TUNING_CACHE.load(path) == 1
        assert TUNING_CACHE.get("qmatmul", (4, 320, 10), torch.int8) == old
        assert not tiling.fits_keys(old, tiling.choose_qmatmul_blocks(
            4, 320, 10))
        t = tiling.qmatmul_tiles(4, 320, 10, platform="cpu")
        heur = tiling.choose_qmatmul_blocks(4, 320, 10)
        assert {k: t[k] for k in heur} == heur
        xc = torch.ones(4, 320, dtype=torch.int8)
        wc = torch.ones(320, 10, dtype=torch.int8)
        assert ensure_tuned("qmatmul", xc, wc, torch.ones(4, 1),
                            torch.ones(1, 10)) is None
        # the same shape's entry in this build's keys is a hit
        TUNING_CACHE.put("qmatmul", (4, 320, 10), torch.int8,
                         {"ksplit": 20})
        assert ensure_tuned("qmatmul", xc, wc, torch.ones(4, 1),
                            torch.ones(1, 10)) == {"ksplit": 20}


class TestStreamAutotune:
    """The reference's ``TestStreamAutotune``, on the CPU with scripted
    timings: the tuner's search and cache writes do not need the card."""

    def _stage(self):
        x = torch.from_numpy(rng.randn(1, 3, 14, 14).astype(np.float32))
        w = torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32))
        b = torch.from_numpy(rng.randn(4).astype(np.float32))
        return x, w, b, SpatialTiling(tile_rows=2, halo=2, pooled=True)

    def test_tile_height_axis_visible(self, monkeypatch):
        monkeypatch.setattr(autotune, "_measure", lambda *a, **k: 1.0)
        x, w, b, tiling = self._stage()
        seen = []
        autotune.tune_stream_fused_conv_block(
            x, w, b, odd="drop", tiling=tiling,
            on_point=lambda tiles, us: seen.append(tiles["th"]))
        assert len(set(seen)) > 1 and tiling.tile_rows in seen

    def test_non_heuristic_winner_lands_in_cache_like_the_reference(
            self, monkeypatch):
        """Scripted timings (po = 6; candidates 2, 3, 4, 6; th 3 wins by
        more than MIN_GAIN): the same winner as the reference's tuner on
        the same script, and the cache row records it."""
        x, w, b, tiling = self._stage()
        jx, jw, jb = (jnp.asarray(t.numpy()) for t in (x, w, b))
        picks = []
        for mod, args, spec in (
                (autotune, (x, w, b), tiling),
                (j_autotune, (jx, jw, jb), JSpatialTiling(2, 2, True))):
            times = iter([100.0, 10.0, 120.0, 90.0])
            monkeypatch.setattr(mod, "_measure",
                                lambda *a, **k: next(times))
            picks.append(mod.tune_stream_fused_conv_block(
                *args, odd="drop", tiling=spec,
                policy=None if mod is autotune else JPolicy(
                    backend="pallas")))
        assert picks[0] == picks[1] == {"th": 3}
        sig = conv_signature(x.shape, w.shape, (1, 1))
        assert TUNING_CACHE.get("stream_fused_conv_block", sig,
                                torch.float32) == {"th": 3}

    def test_cache_row_steers_executor(self):
        """A cache row overrides the SpatialTiling's height and a baked
        policy override beats both; every height gives the untiled op's
        result (fp32 within 1e-5: a band sums like the untiled op)."""
        from repro_torch.ops import fused_conv_block
        from repro_torch.stream import stream_fused_conv_block
        x, w, b, tiling = self._stage()
        pol = ExecPolicy()
        sig = conv_signature(x.shape, w.shape, (1, 1))
        TUNING_CACHE.put("stream_fused_conv_block", sig, torch.float32,
                         {"th": 5})
        assert resolve_tile_rows("stream_fused_conv_block", x, w, (1, 1),
                                 tiling, pol) == 5
        baked = pol.with_options(tiling={"stream_fused_conv_block.th": 3})
        assert resolve_tile_rows("stream_fused_conv_block", x, w, (1, 1),
                                 tiling, baked) == 3
        want = fused_conv_block(x, w, b, odd="drop", policy=pol)
        for p in (pol, baked):
            got = stream_fused_conv_block(x, w, b, odd="drop",
                                          tiling=tiling, policy=p)
            torch.testing.assert_close(got, want, rtol=TOL_FP32,
                                       atol=TOL_FP32)


# ---------------------------------------------------------------- plans

def _jax_plan(quant, **kw):
    return JaxCNN(JaxCNNConfig()).compile(
        JPolicy(quant=quant, backend="xla"), batch=4, **kw)


def _port_plan(quant, **kw):
    return PaperCNN(PaperCNNConfig()).compile(ExecPolicy(quant=quant),
                                              batch=4, **kw)


def _agree(mode, got, want):
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    elif mode == "qformat":
        assert np.abs(got - want).max() <= QSTEP
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32)


class TestPlanAutotune:
    @pytest.mark.parametrize("quant", ["none", "qformat", "int8"])
    def test_bind_bakes_the_stages_the_reference_bakes(self, weights,
                                                       quant):
        """Seeded winners (as a persisted table from a card would hold)
        are baked per stage into the same node ids as in the reference —
        both fused stages, plus the int8 dense — and the baked plan's
        logits stay within the bars of the JAX plan."""
        jparams, tparams = weights
        x = np.random.RandomState(3).randn(4, 1, 28, 28).astype(np.float32)
        # an int8 plan's conv stages run the kernels' int8 route, tuned
        # and cached under dtype int8 with that route's keys
        conv_dt, first, second = (
            (torch.int8, {"items": 2, "cpb": 16}, {"band": 1, "cpb": 8})
            if quant == "int8" else
            (torch.float32, {"split": 4, "cpb": 16, "ipb": 2},
             {"band": 1, "threads": 64}))
        for sig, t in ((SIG1, first), (SIG2, second)):
            TUNING_CACHE.put("fused_conv_block", sig, conv_dt, t)
        TUNING_CACHE.put("qmatmul", (4, 320, 10), torch.int8,
                         {"tile_n": 32, "ksplit": 20})
        J_CACHE.put("fused_conv_block", SIG1, jnp.float32,
                    {"pb": 2, "mb": 5, "bb": 4})
        J_CACHE.put("fused_conv_block", SIG2, jnp.float32,
                    {"pb": 1, "mb": 10, "bb": 2})
        J_CACHE.put("qmatmul", (4, 320, 10), jnp.int8,
                    {"bm": 2, "bn": 5, "bk": 64})
        bound = _port_plan(quant, autotune=True).bind(tparams)
        jbound = _jax_plan(quant, autotune=True).bind(jparams)
        assert sorted(bound.tuned) == sorted(jbound.tuned)
        assert len(bound.tuned) == (3 if quant == "int8" else 2)
        baked = {k: v for t in bound.tuned.values() for k, v in t.items()}
        if quant == "int8":
            assert baked["fused_conv_block.items"] == 2
            assert baked["qmatmul.ksplit"] == 20
        else:
            assert baked["fused_conv_block.split"] == 4
        got = bound(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, _port_plan(quant).bind(tparams)(torch.from_numpy(x)))
        _agree(quant, got, np.asarray(jbound(jnp.asarray(x))))

    def test_bind_on_the_cpu_measures_nothing(self, weights):
        _, tparams = weights
        before = autotune.measurements
        bound = _port_plan("int8", autotune=True).bind(tparams)
        assert bound.tuned == {} and len(TUNING_CACHE) == 0
        assert autotune.measurements == before

    def test_compile_policy_autotune_switches_it_on(self):
        plan = PaperCNN(PaperCNNConfig()).compile(
            ExecPolicy(autotune=True), batch=4)
        assert plan.autotune and not _port_plan("none").autotune

    def test_pin_heuristic_tiles_reverts_bad_winners(self, weights):
        _, tparams = weights
        TUNING_CACHE.put("fused_conv_block", SIG1, torch.float32,
                         {"threads": 64, "cpb": 4, "band": 1, "split": 1,
                          "ipb": 4})
        plan = _port_plan("none", autotune=True)
        assert plan.bind(tparams).tuned
        assert plan.pin_heuristic_tiles(tparams) == 2
        heur = tiling.choose_fused_blocks(*SIG1)
        assert TUNING_CACHE.get("fused_conv_block", SIG1, torch.float32) \
            == {k: heur[k] for k in ("threads", "cpb", "band", "split",
                                     "ipb")}
        assert plan.bind(tparams).tuned == {}

    def test_persisted_cache_skips_measurement(self, weights, tmp_path):
        """The serve scenario: winners persisted by one process are loaded
        by a later bind, which bakes them and measures nothing (the
        autouse fixture fails any measurement)."""
        _, tparams = weights
        TUNING_CACHE.put("fused_conv_block", SIG2, torch.float32,
                         {"split": 8})
        path = tmp_path / "tuned.json"
        TUNING_CACHE.save(path)
        TUNING_CACHE.clear()
        assert TUNING_CACHE.load(path) == 1
        bound = _port_plan("qformat", autotune=True).bind(tparams)
        assert list(bound.tuned.values()) == [
            {"fused_conv_block.split": 8}]

    @pytest.mark.parametrize("quant", ["none", "int8"])
    def test_streamed_stage_bakes_th_like_the_reference(self, weights,
                                                        quant):
        """A streamed stage tunes its band height: a seeded ``th`` is
        baked as ``stream_fused_conv_block.th`` in both packages, and the
        re-banded plans agree by the port's bars."""
        jparams, tparams = weights
        x = np.random.RandomState(4).randn(4, 1, 28, 28).astype(np.float32)
        # an int8 stage's bands slice int8 codes: its entry's dtype
        TUNING_CACHE.put("stream_fused_conv_block", SIG1,
                         torch.int8 if quant == "int8" else torch.float32,
                         {"th": 3})
        J_CACHE.put("stream_fused_conv_block", SIG1, jnp.float32,
                    {"th": 3})
        bound = _port_plan(quant, autotune=True,
                           stream_budget=10_000).bind(tparams)
        jbound = _jax_plan(quant, autotune=True,
                           stream_budget=10_000).bind(jparams)
        assert bound.tuned == jbound.tuned
        assert {"stream_fused_conv_block.th": 3} in bound.tuned.values()
        _agree(quant, bound(torch.from_numpy(x)).numpy(),
               np.asarray(jbound(jnp.asarray(x))))
