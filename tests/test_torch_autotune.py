"""The port's kernel autotuner (``transmogrifai_tpu_torch/perf/autotune.py``).

The reference's ``tests/test_autotune.py`` with the import swapped: the
store contracts end to end (sweep once then cache hit, under first-contact
thread races too; verified before eligible; corrupt / schema-drifted /
unverified entries read as defaults), the ``tune=<digest>`` cache-token
component riding ``dispatch.cache_token()`` exactly when a non-default
winner is adopted, the launchers consuming a planted winner, and ``cli
tune``.  Sweeps run on the CPU here (``dispatch.use_device("cpu")``), where
each family's grid is what its plain version can vary.

Then the port's own plan arithmetic, pure Python: at the default dims and
at ``chip_smoke.py`` phase 26's shapes every card candidate passes its
launcher's fit check and candidate 0 is ``plan()``'s; a planted card winner
reaches ``histogram`` / ``splitscan`` / ``routing``'s plan and the encode
grid cap only at its own shape class; a misfit winner falls back to the
default plan with a warning.

The reference's ``TestTuningIntFallback`` is not here: ``TMOG_HIST_CHUNK``
and ``TMOG_HIST_UNROLL`` are XLA knobs the port has no counterpart of.
"""

import json
import logging
import os
import threading

import pytest
import torch

from transmogrifai_tpu_torch.perf import autotune
from transmogrifai_tpu_torch.perf.kernels import dispatch
from transmogrifai_tpu_torch.perf.kernels import encode as KE
from transmogrifai_tpu_torch.perf.kernels import histogram as KH
from transmogrifai_tpu_torch.perf.kernels import routing as KR
from transmogrifai_tpu_torch.perf.kernels import splitscan as KS

#: the card's name as ``torch.cuda.get_device_name`` gives it, and its kind
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD = "nvidia-h100-80gb-hbm3"
CUDA0 = torch.device("cuda", 0)

#: chip_smoke.py phase 26's shapes: K1's int8 level of phase 9's RF CV, the
#: float GBT level, K2 at the RF CV's deepest level, K3 at 150 and 3 lanes,
#: the encode kernel's 40 slots over 1024 and 262 144 rows
PHASE26 = [
    ("hist", {"lanes": 150, "nodes": 16, "rows": 1 << 20, "features": 128,
              "bins": 32, "classes": 1, "int_exact": 1}),
    ("hist", {"lanes": 3, "nodes": 2, "rows": 1 << 20, "features": 128,
              "bins": 32, "classes": 1, "int_exact": 0}),
    ("split", {"lanes": 150, "nodes": 32, "classes": 1, "features": 128,
               "bins": 32}),
    ("route", {"lanes": 150, "rows": 1 << 20, "features": 128}),
    ("route", {"lanes": 3, "rows": 1 << 20, "features": 128}),
    ("encode", {"rows": 1024, "slots": 40, "width": 730}),
    ("encode", {"rows": 1 << 18, "slots": 40, "width": 728}),
]
SHAPES = [(f, dict(autotune.DEFAULT_DIMS[f])) for f in autotune.FAMILIES] + PHASE26


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """A throwaway winner store wired in as THE process store, with clean
    in-process adoption state on both sides of the test; entry points run
    on the CPU."""
    root = str(tmp_path / "autotune")
    monkeypatch.setenv("TMOG_AUTOTUNE_DIR", root)
    autotune.reset()
    with dispatch.use_device("cpu"):
        yield root
    autotune.reset()


@pytest.fixture()
def card(store, monkeypatch):
    """As if the process saw one H100: its kind names store entries and
    adopted winners (no kernel runs)."""
    monkeypatch.setattr(autotune, "_card_name", lambda index: CARD_NAME)
    monkeypatch.setattr(autotune, "_local_kinds", lambda: {"cpu", CARD})
    autotune.reset()
    return store


def _plant_winner(store_root, family, cls, params, *, schema=None,
                  verified=True, kind=None):
    """Write a store entry the way a prior process's sweep would have."""
    kind = kind or autotune.device_kind()
    entry = {
        "schema": autotune.SCHEMA_VERSION if schema is None else schema,
        "device_kind": kind, "family": family,
        "shape_class": cls, "params": params, "verified": verified,
        "candidates": 5, "eligible": 5, "best_seconds": 1e-4,
        "default_seconds": 2e-4, "swept_unix": 0.0,
    }
    path = autotune._entry_path(kind, family, cls, store_root)
    os.makedirs(store_root, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(entry, fh)
    return path


def _encode_cls():
    return autotune.shape_class("encode", "cpu", rows=4096, slots=1, width=16)


class TestStoreRobustness:
    def test_corrupt_entry_reads_as_defaults(self, store):
        cls = _encode_cls()
        path = autotune._entry_path(autotune.device_kind(), "encode", cls,
                                    store)
        os.makedirs(store, exist_ok=True)
        with open(path, "w") as fh:
            fh.write('{"schema": 1, "params": {"gri')  # torn write
        dec = autotune.ensure_tuned("encode", sweep_on_miss=False,
                                    store=store)
        assert dec.source == "default"
        assert dec.params == autotune.family_defaults("encode", cls)
        assert autotune.winners(store) == []

    def test_schema_mismatch_reads_as_defaults(self, store):
        cls = _encode_cls()
        _plant_winner(store, "encode", cls, {"grid_cap": 256},
                      schema=autotune.SCHEMA_VERSION + 1)
        dec = autotune.ensure_tuned("encode", sweep_on_miss=False,
                                    store=store)
        assert dec.source == "default"
        assert autotune.winners(store) == []

    def test_unverified_entry_is_ignored(self, store):
        cls = _encode_cls()
        _plant_winner(store, "encode", cls, {"grid_cap": 256}, verified=False)
        dec = autotune.ensure_tuned("encode", sweep_on_miss=False,
                                    store=store)
        assert dec.source == "default"

    def test_clear_removes_entries_and_resets_adoption(self, store):
        cls = _encode_cls()
        _plant_winner(store, "encode", cls, {"grid_cap": 256})
        assert len(autotune.winners(store)) == 1
        assert autotune.clear(store) == 1
        assert autotune.winners(store) == []
        assert autotune.ensure_tuned("encode", sweep_on_miss=False,
                                     store=store).source == "default"


class TestSweepOnce:
    def test_sweep_persists_then_fresh_state_reads_cached(self, store):
        swept = autotune.sweep("encode", store=store, reps=1)
        assert swept.source == "swept" and swept.verified
        assert autotune.sweep_count() == 1
        autotune.reset()
        dec = autotune.ensure_tuned("encode", sweep_on_miss=False,
                                    store=store)
        assert dec.source == "cached"
        assert dec.params == swept.params
        assert autotune.sweep_count() == 0  # the warm store swept NOTHING

    def test_concurrent_first_contact_sweeps_once(self, store):
        barrier = threading.Barrier(2)
        results, errors = [], []

        def contact():
            try:
                barrier.wait(timeout=30)
                with dispatch.use_device("cpu"):
                    results.append(autotune.ensure_tuned(
                        "encode", sweep_on_miss=True, store=store))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=contact) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        assert autotune.sweep_count() == 1, \
            "two racing first contacts must produce exactly ONE sweep"
        assert results[0].params == results[1].params
        # the store entry the race produced is whole (no torn writes)
        entries = autotune.winners(store)
        assert len(entries) == 1 and entries[0]["verified"] is True

    def test_ensure_tuned_unarmed_never_sweeps(self, store):
        dec = autotune.ensure_tuned("encode", sweep_on_miss=False,
                                    store=store)
        assert dec.source == "default"
        assert autotune.sweep_count() == 0

    @pytest.mark.parametrize("family", ["hist", "route"])
    def test_cpu_sweep_verifies_every_row_chunk(self, store, family):
        """On the CPU the plain version's row chunk is the grid: every
        candidate verifies (bitwise on the integer fixtures), and the
        winner is one of them."""
        dec = autotune.sweep(family, store=store, reps=1)
        cls = dec.shape_class
        grid = autotune.family_candidates(family, cls)
        assert grid[0] == autotune.family_defaults(family, cls)
        assert dec.candidates == dec.eligible == len(grid) > 1
        assert dec.params in grid and dec.verified
        entry = autotune.winners(store)[0]
        assert [t["params"] for t in entry["trials"]] == grid
        assert all(t["verified"] for t in entry["trials"])

    def test_env_arms_first_contact_sweep(self, store, monkeypatch):
        monkeypatch.setenv("TMOG_AUTOTUNE", "1")
        dec = autotune.ensure_tuned("route", store=store)
        assert dec.source == "swept" and autotune.sweep_count() == 1
        assert autotune.ensure_tuned("route", store=store) is dec
        assert autotune.sweep_count() == 1


def _trial(params, reps):
    return {"params": params, "verified": True, "seconds": min(reps), "reps": reps}


class TestRunNoise:
    """A sweep keeps the default unless the fastest candidate's slowest rep
    beats the default's fastest: a gain inside run noise would move the
    cache token, and every artifact key, for nothing."""

    DEFAULT, OTHER = {"grid_cap": 1056}, {"grid_cap": 4224}

    @pytest.mark.parametrize("other_reps, adopted", [
        ([0.99, 1.05, 1.10], "default"),    # faster by 1 %, inside the spread
        ([0.80, 0.85, 0.90], "other"),      # every rep beats the default's best
        ([0.80, 0.85, 1.00], "default"),    # its slowest rep ties the default
        ([1.20, 1.30, 1.40], "default"),    # slower
    ])
    def test_the_default_stays_unless_beaten_past_the_spread(self, other_reps, adopted):
        trials = [_trial(self.DEFAULT, [1.00, 1.02, 1.10]),
                  _trial(self.OTHER, other_reps)]
        params, best, default = autotune._pick(trials, self.DEFAULT)
        assert params == (self.DEFAULT if adopted == "default" else self.OTHER)
        assert default == 1.00
        assert best == (1.00 if adopted == "default" else min(other_reps))

    def test_without_a_timed_default_the_fastest_wins(self):
        trials = [{"params": self.DEFAULT, "verified": False, "seconds": None},
                  _trial(self.OTHER, [0.5, 0.7]), _trial({"grid_cap": 264}, [0.6])]
        assert autotune._pick(trials, self.DEFAULT) == (self.OTHER, 0.5, None)

    def test_a_sweep_of_ties_keeps_the_default_and_the_token(self, store, monkeypatch):
        monkeypatch.setattr(autotune, "_time_rep", lambda run, dev, per: (run(), 1e-3)[1])
        dec = autotune.sweep("route", store=store, reps=3)
        assert dec.eligible == dec.candidates > 1
        assert dec.params == autotune.family_defaults("route", dec.shape_class)
        assert dec.best_seconds == dec.default_seconds == 1e-3
        autotune.reset()
        assert autotune.tuning_token() == ""
        assert autotune.winners(store)[0]["params"] == dec.params


class TestCacheToken:
    def test_untuned_token_is_empty(self, store):
        assert autotune.tuning_token() == ""
        assert "tune=" not in dispatch.cache_token()

    def test_default_winner_does_not_move_the_token(self, store):
        cls = _encode_cls()
        _plant_winner(store, "encode", cls,
                      autotune.family_defaults("encode", cls))
        assert autotune.tuning_token() == ""

    def test_non_default_winner_rides_cache_token(self, store):
        baseline = dispatch.cache_token()
        cls = _encode_cls()
        _plant_winner(store, "encode", cls, {"grid_cap": 512})
        autotune.reset()  # a fresh process adopting the warm store
        token = autotune.tuning_token()
        assert token.startswith("tune=")
        assert dispatch.cache_token() == f"{baseline}:{token}"
        # tokens are content-addressed: a different winner, different token
        _plant_winner(store, "encode", cls, {"grid_cap": 256})
        autotune.reset()
        assert autotune.tuning_token() not in ("", token)
        # and the memo of cache_token follows adoption both ways
        assert dispatch.cache_token() == f"{baseline}:{autotune.tuning_token()}"
        autotune.clear(store)
        assert dispatch.cache_token() == baseline

    def test_provenance_names_the_adopted_winners(self, store):
        cls = _encode_cls()
        _plant_winner(store, "encode", cls, {"grid_cap": 512})
        autotune.reset()
        prov = autotune.provenance()
        assert prov["store"] == store
        assert prov["token"].startswith("tune=")
        assert prov["winners"][f"encode/{cls}"] == {
            "params": {"grid_cap": 512}, "source": "cached"}

    def test_a_card_winner_moves_the_token_of_a_process_that_has_the_card(self, card):
        dims = dict(PHASE26[0][1])
        cls = autotune.shape_class("hist", "cuda", **dims)
        _plant_winner(card, "hist", cls, {"warps": 16, "min_slice_rows": 4096},
                      kind=CARD)
        _plant_winner(card, "hist", cls, {"warps": 8, "min_slice_rows": 4096},
                      kind="nvidia-a100-sxm4-80gb")   # another card's: not adopted
        autotune.reset()
        prov = autotune.provenance()
        assert prov["token"].startswith("tune=")
        assert prov["winners"] == {f"hist/{cls}": {
            "params": {"warps": 16, "min_slice_rows": 4096}, "source": "cached"}}


class TestKernelsConsumeWinners:
    def test_cpu_hist_takes_the_planted_row_chunk(self, store, monkeypatch):
        L, n, d, nn, n_bins = 2, 300, 7, 4, 8
        g = torch.Generator().manual_seed(3)
        local = torch.randint(-1, nn, (L, n), generator=g, dtype=torch.int32)
        gh = torch.randint(-3, 4, (L, 2, n), generator=g).to(torch.int8)
        binned = torch.randint(0, n_bins + 1, (n, d), generator=g, dtype=torch.int32)
        ref = KH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
        cls = autotune.shape_class("hist", "cpu", rows=n, features=d, bins=n_bins,
                                   lanes=L, nodes=nn, classes=1, int_exact=1)
        _plant_winner(store, "hist", cls, {"chunk": 64})
        autotune.reset()
        seen = []
        plain = KH.hist_level_torch
        monkeypatch.setattr(KH, "hist_level_torch",
                            lambda *a, **k: seen.append(k["chunk"]) or plain(*a, **k))
        got = KH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
        assert seen == [64] and torch.equal(got, ref)
        # another shape class (more features) keeps the default chunk
        KH.hist_level(local, gh, torch.cat([binned, binned], 1), nn, n_bins,
                      int_exact=True)
        assert seen == [64, KH.PLAIN_CHUNK]

    def test_cpu_route_takes_the_planted_row_chunk(self, store, monkeypatch):
        n, d, L = 300, 9, 3
        g = torch.Generator().manual_seed(4)
        binned = torch.randint(0, 33, (n, d), generator=g, dtype=torch.int32)
        idx = torch.randint(-1, d + 1, (L, n), generator=g, dtype=torch.int32)
        ref = KR.row_select_lanes_torch(binned, idx)
        cls = autotune.shape_class("route", "cpu", rows=n, features=d, lanes=L)
        _plant_winner(store, "route", cls, {"chunk": 128})
        autotune.reset()
        seen = []
        plain = KR.row_select_lanes_torch
        monkeypatch.setattr(KR, "row_select_lanes_torch",
                            lambda *a, **k: seen.append(k["chunk"]) or plain(*a, **k))
        assert torch.equal(KR.row_select_lanes(binned, idx), ref)
        assert seen == [128]

    def test_misfit_cpu_chunk_falls_back_with_a_warning(self, store, caplog):
        n, d, L = 300, 9, 3
        binned = torch.zeros((n, d), dtype=torch.int32)
        idx = torch.zeros((L, n), dtype=torch.int32)
        cls = autotune.shape_class("route", "cpu", rows=n, features=d, lanes=L)
        _plant_winner(store, "route", cls, {"chunk": "wide"})
        autotune.reset()
        with caplog.at_level(logging.WARNING, logger=autotune.log.name):
            out = KR.row_select_lanes(binned, idx)
        assert torch.equal(out, torch.zeros((L, n), dtype=torch.int32))
        assert any("does not fit" in r.message for r in caplog.records)


def _winner_params(family, dims):
    """A card candidate other than the default, for each family."""
    cls = autotune.shape_class(family, "cuda", **dims)
    grid = autotune.family_candidates(family, cls)
    assert len(grid) > 1, (family, dims)
    return grid[-1], grid[0]


def _tuned(family, dims):
    """The plan (or grid cap) a launch at ``dims`` on the card takes."""
    if family == "hist":
        return KH.tuned_plan(CUDA0, *autotune._hist_args(dims))
    if family == "split":
        return KS.tuned_plan(CUDA0, dims["lanes"], dims["nodes"], dims["classes"],
                             dims["features"], dims["bins"])
    if family == "route":
        return KR.tuned_plan(CUDA0, dims["lanes"], dims["rows"], dims["features"])
    table = KE.plan_slots(autotune._encode_specs(KE, dims["slots"], dims["width"]))
    return KE.tuned_grid_cap(CUDA0, dims["rows"], table)


class TestCardPlans:
    """Pure plan arithmetic of the card's launchers: nothing launches."""

    @pytest.mark.parametrize("family, dims", SHAPES,
                             ids=[f"{f}-{i}" for i, (f, _) in enumerate(SHAPES)])
    def test_every_candidate_fits_and_candidate_0_is_the_rules_plan(self, family, dims):
        cls = autotune.shape_class(family, "cuda", **dims)
        grid = autotune.family_candidates(family, cls)
        assert grid[0] == autotune.family_defaults(family, cls)
        assert len(grid) == len({json.dumps(c, sort_keys=True) for c in grid}) > 1
        assert autotune.card_plan(family, dims, grid[0]) == autotune.card_plan(family, dims)
        for params in grid:
            p = autotune.card_plan(family, dims, params)   # raises on a misfit
            assert autotune._plan_params(family, p, dims) == params
            if family == "hist":
                most = KH._MAX_THREADS if dims["int_exact"] else KH.F32_MAX_THREADS
                assert p["smem"] <= KH._CTA_SMEM_MAX and p["threads"] <= most
                assert p["slices"] * p["rows_per_slice"] >= dims["rows"]
            elif family == "split":
                assert p.threads == p.feats * p.groups * p.blocks_per_cta
                assert p.threads <= KS.SCAN_MAX_THREADS and p.feats % 32 == 0
                assert p.smem <= KS.SCAN_SMEM_MAX
                assert not p.staged or p.stride >= dims["bins"] + 1
            elif family == "route":
                assert p.threads <= KR.THREADS and p.threads % 32 == 0
                assert p.path == "direct" or (p.threads % p.rows == 0
                                              and p.smem <= KR.TILE_SMEM
                                              and p.stride >= dims["features"])
            else:
                assert 1 <= p <= 2 ** 31 - 1

    @pytest.mark.parametrize("family, dims", PHASE26,
                             ids=[f"{f}-{i}" for i, (f, _) in enumerate(PHASE26)])
    def test_planted_winner_reaches_the_plan_only_at_its_class(self, card, family, dims):
        default = _tuned(family, dims)          # no winner: the rules
        assert default == autotune.card_plan(family, dims)
        params, _ = _winner_params(family, dims)
        cls = autotune.shape_class(family, "cuda", **dims)
        _plant_winner(card, family, cls, params, kind=CARD)
        autotune.reset()
        tuned = _tuned(family, dims)
        assert tuned == autotune.card_plan(family, dims, params) != default
        assert dispatch.cache_token().endswith(autotune.tuning_token())
        # another class (other features or lanes) keeps the rules' plan
        other = dict(dims, **({"slots": dims["slots"] - 1} if family == "encode"
                              else {"features": dims["features"] - 32}))
        if family == "encode":
            other["width"] -= 5
        assert _tuned(family, other) == autotune.card_plan(family, other)
        # a CPU class never reaches the card
        assert autotune.lookup(family, autotune.shape_class(family, "cpu", **dims),
                               "cpu") is None

    @pytest.mark.parametrize("family, params", [
        ("hist", {"warps": 64, "min_slice_rows": 8192}),
        ("hist", {"R": 24, "waves": 1}),
        ("split", {"staged": True, "FT": 48, "S": 1}),
        ("split", {"staged": True, "FT": 256, "S": 4}),
        ("route", {"path": "tile", "rows": 96, "threads": 256}),
        ("route", {"path": "direct", "rows": 256, "threads": 512}),
        ("encode", {"grid_cap": 0}),
        ("encode", {"block": 512}),
    ])
    def test_misfit_winner_falls_back_with_a_warning(self, card, caplog, family, params):
        dims = {"hist": PHASE26[1 if "R" in params else 0][1], "split": PHASE26[2][1],
                "route": PHASE26[3][1], "encode": PHASE26[5][1]}[family]
        cls = autotune.shape_class(family, "cuda", **dims)
        _plant_winner(card, family, cls, params, kind=CARD)
        autotune.reset()
        with caplog.at_level(logging.WARNING, logger=autotune.log.name):
            got = _tuned(family, dims)
        assert got == autotune.card_plan(family, dims)
        assert any("does not fit" in r.message for r in caplog.records)

    def test_no_store_leaves_every_plan_and_the_token_untouched(self, card):
        token = dispatch.cache_token()
        assert "tune=" not in token
        for family, dims in PHASE26:
            assert _tuned(family, dims) == autotune.card_plan(family, dims)
        assert dispatch.cache_token() == token


class TestCliTune:
    def test_show_run_clear_roundtrip(self, store, capsys):
        from transmogrifai_tpu_torch.cli.gen import main

        assert main(["tune", "show", "--store", store]) == 0
        assert "no verified winners" in capsys.readouterr().out
        assert main(["tune", "run", "--family", "encode", "--reps", "1",
                     "--store", store, "--format", "json",
                     "--device", "cpu"]) == 0
        lines = [json.loads(ln) for ln
                 in capsys.readouterr().out.strip().splitlines()]
        assert lines[0]["sweep"]["family"] == "encode"
        assert lines[0]["sweep"]["verified"] is True
        assert main(["tune", "show", "--store", store,
                     "--format", "json"]) == 0
        lines = [json.loads(ln) for ln
                 in capsys.readouterr().out.strip().splitlines()]
        assert lines[0]["winner"]["family"] == "encode"
        assert lines[-1]["count"] == 1
        assert main(["tune", "clear", "--store", store]) == 0
        assert autotune.winners(store) == []

    def test_run_refuses_unknown_family(self, store):
        from transmogrifai_tpu_torch.cli.gen import main

        with pytest.raises(SystemExit, match="unknown family"):
            main(["tune", "run", "--family", "nope", "--store", store])

    def test_run_every_family_on_the_cpu(self, store, capsys):
        from transmogrifai_tpu_torch.cli.gen import main

        assert main(["tune", "run", "--reps", "1", "--store", store,
                     "--format", "json", "--device", "cpu"]) == 0
        sweeps = [json.loads(ln)["sweep"] for ln
                  in capsys.readouterr().out.strip().splitlines()]
        assert [s["family"] for s in sweeps] == list(autotune.FAMILIES)
        assert all(s["verified"] and s["eligible"] == s["candidates"] for s in sweeps)
        assert len(autotune.winners(store)) == len(autotune.FAMILIES)
