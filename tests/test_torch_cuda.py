"""The port's CUDA kernels against their plain PyTorch versions, on the card
(the encode kernel's left-closed bucketize slots among them), the wide
pipeline's training from raw columns (its whole-table transform plan and the
SanityChecker, and with the DSL's features added) on the card against the
CPU, Word2Vec's step loop and LDA's EM on the card against the same
functions on the CPU, and the fleet's reduced-precision lowering, shared
prefix state and eviction on the card.

Marked ``cuda``: each test skips where there is no card.  The machine with
the card has no JAX, so this file imports torch and the port only; run it
there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.perf.kernels import encode as TKE
from torch_encode_cases import fixture_inputs, slot_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _codes(n: int, width: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(-3, width + 7, n).astype(np.int32)
    edge = np.array([-1, width, width + 5, 0], np.int32)[:n]
    codes[:len(edge)] = edge
    return codes


def _values(n: int, splits: np.ndarray, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).normal(size=n) * 1.5).astype(np.float32)
    x[::7] = np.nan
    x[1], x[2] = np.inf, -np.inf
    finite = splits[np.isfinite(splits)]
    x[3:3 + len(finite)] = finite
    return x


@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
@pytest.mark.parametrize("width", [1, 22, 300])
def test_onehot_kernel_bitwise_and_counted(n, width):
    c = torch.from_numpy(_codes(n, width, seed=n)).cuda()
    before = TKE.onehot_launches
    got = TKE.onehot_codes(c, width)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.onehot_codes_torch(c, width))
    assert TKE.onehot_launches == before + 1


@pytest.mark.parametrize("splits", [[-np.inf, -0.5, 0.1, 0.9, np.inf],
                                    [-1.0, 0.0, 0.5, 2.0]])
@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("track_invalid", [True, False])
def test_bucketize_kernel_bitwise_and_counted(splits, track_nulls, track_invalid):
    s_np = np.asarray(splits, np.float32)
    x = torch.from_numpy(_values(1024, s_np, seed=5)).cuda()
    s = torch.from_numpy(s_np).cuda()
    before = TKE.bucketize_launches
    got = TKE.bucketize_right_encode(x, s, track_nulls, track_invalid)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.bucketize_right_encode_torch(
        x, s, track_nulls, track_invalid))
    assert TKE.bucketize_launches == before + 1


# -- the fused encode kernel: every slot of a table in one launch --------------

@pytest.mark.parametrize("n", [1, 37, 1024, 1009])
@pytest.mark.parametrize("n_slots", [12, 40])
def test_encode_slots_kernel_bitwise_one_launch(n, n_slots):
    specs, inputs = slot_case(n, n, "cuda", n_slots)
    table = TKE.plan_slots(specs)
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + 1
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


@pytest.mark.parametrize("n_slots", [64, 70, 129])
def test_encode_slots_chunks_counted_per_launch(n_slots):
    specs, inputs = slot_case(300, 7, "cuda", n_slots)
    table = TKE.plan_slots(specs)
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + len(table.chunks)
    assert len(table.chunks) == -(-n_slots // TKE.MAX_SLOTS)
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


@pytest.mark.parametrize("pad, offset", [(0, 0), (4, 0), (3, 0), (4, 1), (8, 2)],
                         ids=["dense", "aligned_stride", "odd_stride",
                              "misaligned_base", "offset_2"])
def test_encode_slots_into_strided_destination(pad, offset):
    """An output that is a view into a wider buffer: every column of the
    view is written, nothing around it; misaligned bases and odd strides
    take the scalar stores."""
    specs, inputs = slot_case(129, 11, "cuda", 70)
    table = TKE.plan_slots(specs)
    w = table.width
    buf = torch.full((129, offset + w + pad), 7.0, device="cuda")
    TKE.encode_slots(inputs, table, buf[:, offset:offset + w])
    torch.cuda.synchronize()
    assert torch.equal(buf[:, offset:offset + w], TKE.encode_slots_torch(inputs, table))
    assert bool((buf[:, :offset] == 7.0).all())
    assert bool((buf[:, offset + w:] == 7.0).all())


def test_encode_slots_fixture_table_bitwise():
    """The serving fixture's whole table (32 one-hot and 8 bucketize slots)
    at 1024, 37 and a prime row count, into the plan's padded buffer."""
    from transmogrifai_tpu_torch import WorkflowModel

    table = WorkflowModel.load(FIXTURE).serving_plan(device="cpu")._encode_table
    assert len(table) == 40 and table.width == 730
    for n in (1024, 37, 997):
        inputs = fixture_inputs(table, n, n, "cuda")
        buf = torch.empty((n, 732), device="cuda")[:, :730]
        before = TKE.encode_slots_launches
        TKE.encode_slots(inputs, table, buf)
        torch.cuda.synchronize()
        assert TKE.encode_slots_launches == before + 1
        assert torch.equal(buf, TKE.encode_slots_torch(inputs, table))


def _records(schema: dict, n: int, rng) -> list:
    """Requests from the fixture's schema with missing values, unseen levels
    and absent fields."""
    out = []
    for _ in range(n):
        r = {}
        for f in schema["features"]:
            u = rng.random()
            if f.get("response") or u < 0.02:
                continue
            if u < 0.1:
                r[f["name"]] = None
            elif f["type"] == "Real":
                r[f["name"]] = float(rng.normal())
            elif f["type"] == "Binary":
                r[f["name"]] = bool(rng.random() < 0.3)
            else:
                r[f["name"]] = (f"unseen{int(rng.integers(1000))}" if u < 0.15
                                else str(rng.choice(f["levels"])))
        out.append(r)
    return out


def test_serving_plan_encodes_a_batch_in_one_launch():
    """The card plan: one encode launch and one copy per operand dtype a
    batch, records equal to the CPU plan's."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    model = WorkflowModel.load(FIXTURE)
    plan, cpu_plan = model.serving_plan(), model.serving_plan(device="cpu")
    rng = np.random.default_rng(3)
    for n in (1024, 37):
        recs = _records(schema, n, rng)
        TKE.reset_launch_counts()
        copies = plan.metrics()["h2d_copies"]
        got = plan.score(recs)
        assert TKE.launch_counts() == {"onehot_codes": 0, "bucketize_right_encode": 0,
                                       "encode_slots": 1, "encode_slots.slots": 40}
        assert plan.metrics()["h2d_copies"] == copies + 2
        assert got == cpu_plan.score(recs)


def test_server_on_the_card_fails_an_oom_batch_not_to_the_cpu():
    """An out-of-memory error at "device" that survives the retries and
    splits fails every request of its batch; nothing is served by the host
    path, and the card plan has none."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.serve import FaultHarness, ScoringServer

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    recs = _records(schema, 16, np.random.default_rng(5))
    model = WorkflowModel.load(FIXTURE)
    oom = FaultHarness().fail_when("device", lambda ctx: True,
                                   lambda: torch.OutOfMemoryError("injected"))
    with ScoringServer(model, max_batch=16, max_wait_ms=60_000, warm=False,
                       resilience={"seed": 0, "backoff_base_s": 1e-3}) as server:
        with oom:
            errs = [f.exception(timeout=60) for f in [server.submit(r) for r in recs]]
        rows = [f.result(timeout=60) for f in [server.submit(r) for r in recs]]
        res, plan = server.resilience.metrics(), server.plan.metrics()
        with pytest.raises(RuntimeError, match="no host path"):
            server.plan.score_host(recs)
    assert all(isinstance(e, torch.OutOfMemoryError) for e in errs)
    assert (res["device_failures"], res["fallback_batches"], res["fallback_records"]) \
        == (1, 0, 0)
    assert plan["host_scored_records"] == 0
    assert rows == model.serving_plan(device="cpu").score(recs)


# -- telemetry on the card (obs/) ------------------------------------------------

def test_profile_capture_names_the_encode_kernel(tmp_path, monkeypatch):
    """``TMOG_PROFILE`` around one served batch: the exported Chrome trace
    names the hand-written encode kernel, and the batch's records equal an
    unprofiled batch's."""
    import json

    load, schema = _wide()
    plan = load(FIXTURE).serving_plan().warm()
    recs = _records(schema, 256, np.random.default_rng(11))
    plain = plan.score(recs)
    monkeypatch.setenv("TMOG_PROFILE", str(tmp_path / "prof"))
    profiled = plan.score(recs)
    monkeypatch.delenv("TMOG_PROFILE")
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert any("encode_slots_kernel" in n for n in names), sorted(names)[:40]
    assert profiled == plain
    from transmogrifai_tpu_torch.obs.profile import last_capture

    cap = last_capture()
    assert cap["launches"] >= 1 and cap["complete"], cap


def test_warm_served_batches_record_no_compile_event_on_the_card():
    """After ``warm()`` (every bucket's staging and landing sets, the
    kernel library loaded) served batches record 0 compile events; a cold
    bucket inside a warm context records TM901."""
    from transmogrifai_tpu_torch.obs import FlightRecorder, flight
    from transmogrifai_tpu_torch.perf import measure_compiles

    load, schema = _wide()
    model = load(FIXTURE)
    plan = model.serving_plan().warm()
    recs = _records(schema, 300, np.random.default_rng(12))
    rec = flight.install_recorder(FlightRecorder())
    try:
        with measure_compiles() as probe:
            for n in (1, 37, 300):
                plan.score(recs[:n])
        assert probe.backend_compiles == 0
        assert rec.events("backend_compile") == []
        cold = model.serving_plan(min_bucket=2, max_bucket=2)
        cold.release_executables()
        with flight.compile_context("test.warm", warm=True):
            cold.score(recs[:2])
        assert rec.unexpected_compiles >= 1
        assert {d.code for d in rec.diagnostics()} == {"TM901"}
    finally:
        flight.uninstall_recorder()


def test_per_tenant_device_seconds_sum_to_the_total_on_the_card():
    """Two tenants on one card: their ``device_seconds`` (the prefix as
    CUDA events time it) sum to the batch total, which equals the plans'
    own summed ``device_ms``."""
    from transmogrifai_tpu_torch.serve import FleetServer

    load, schema = _wide()
    recs = _records(schema, 256, np.random.default_rng(13))
    with FleetServer(max_batch=64, max_wait_ms=2) as fleet:
        fleet.register("a", load(FIXTURE))
        fleet.register("b", load(FIXTURE))
        futs = [fleet.submit("ab"[i % 2], r) for i, r in enumerate(recs)]
        for f in futs:
            f.result(60)
        total = fleet.batcher.metrics()["device_seconds"]
        per = fleet.batcher.tenant_metrics()
        status = fleet.statusz()
        plans = sum(fleet.models.get(t).swapper.active.plan.metrics()["device_ms"]
                    for t in "ab") / 1e3
    assert total > 0 and per["a"]["device_seconds"] > 0 and per["b"]["device_seconds"] > 0
    assert sum(r["device_seconds"] for r in per.values()) == pytest.approx(total, rel=1e-9)
    assert status["fleet"]["device_seconds"] == total
    assert total == pytest.approx(plans, rel=1e-9)


# -- the fleet: reduced precision, shared prefix state, eviction ----------------

def _wide():
    import json

    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    return WorkflowModel.load, schema


def _settled() -> int:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_precision_lowering_on_the_card_equals_the_cpu(precision):
    """The lowering over the packed float32 staging block, on the card
    against the CPU: int8 bitwise, bf16 bitwise (a cast), prefix outputs
    likewise, and the encode kernel launched once a batch."""
    from transmogrifai_tpu_torch.serve import compile_plan
    from transmogrifai_tpu_torch.serve.plan import lower_block

    rng = np.random.default_rng(11)
    block = (rng.standard_normal((68, 1024)) * 10.0 ** rng.uniform(-3, 3, (68, 1))
             ).astype(np.float32)
    block[:, ::97] = np.nan
    block[3, 5] = np.inf
    got = lower_block(torch.from_numpy(block).cuda(), precision).float().cpu()
    want = lower_block(torch.from_numpy(block), precision).float()
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    load, schema = _wide()
    model = load(FIXTURE)
    card = compile_plan(model, precision=precision)
    cpu = compile_plan(model, precision=precision, device="cpu")
    recs = _records(schema, 1024, np.random.default_rng(4))
    entries = cpu._encode_records(recs)[1]
    TKE.reset_launch_counts()
    outs = card._fused(*entries)
    assert TKE.encode_slots_launches == 1
    for a, b in zip(outs, cpu._fused(*entries)):
        assert np.array_equal(a, b, equal_nan=True)


def test_shared_fingerprint_allocates_no_device_bytes():
    from transmogrifai_tpu_torch.serve import FleetServer

    load, schema = _wide()
    recs = _records(schema, 64, np.random.default_rng(6))
    with FleetServer(max_batch=64, max_wait_ms=2) as fleet:
        fleet.register("a", load(FIXTURE))
        before = _settled()
        fleet.register("twin", load(FIXTURE))
        assert _settled() == before
        m = fleet.metrics()
        assert m["fleet"]["shared_prefix_registrations"] == 1
        assert m["tenants"]["twin"]["plan"]["staging_builds"] == 0
        rows = [f.result(60) for f in [fleet.submit("twin", r) for r in recs]]
    assert len(rows) == 64


def test_eviction_frees_what_resident_hbm_bytes_said():
    """Evicting a cold tenant frees its staging buffers and constants:
    ``memory_allocated`` falls by the bytes its plan reports released, and
    the fleet's resident estimate by that fingerprint's estimate."""
    from transmogrifai_tpu_torch.serve import FleetServer

    load, schema = _wide()
    with FleetServer(max_batch=256, max_wait_ms=2) as fleet:
        fleet.register("cold", load(FIXTURE))
        fleet.register("hot", load(FIXTURE), precision="bf16",
                       calibration=_records(schema, 64, np.random.default_rng(1)))
        cold_plan = fleet.models.get("cold").swapper.active.plan
        resident = fleet.models.resident_hbm_bytes()
        each = fleet.models._peak_bytes(cold_plan)
        before = _settled()
        fleet.models._release_tenant(fleet.models.get("cold"))
        freed = before - _settled()
        assert cold_plan.last_released_bytes > 0
        assert abs(freed - cold_plan.last_released_bytes) <= 512
        assert fleet.models.resident_hbm_bytes() == resident - each


# -- tree kernels (K1 histogram, K2 split scan, K3 routing) ---------------------

from transmogrifai_tpu_torch.perf.kernels import histogram as TH  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import routing as TR  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import splitscan as TS  # noqa: E402


def _hist_case(L, n, d, nn, n_bins, two_k, int_exact, seed):
    rng = np.random.default_rng(seed)
    local = rng.integers(-2, nn + 1, (L, n)).astype(np.int32)
    if int_exact:
        gh = rng.integers(-9, 10, (L, two_k, n)).astype(np.int8)
        gh[:, :, ::5] = 0                      # zero-weight rows
    else:
        gh = rng.normal(size=(L, two_k, n)).astype(np.float32)
    binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (local, gh, binned)]


# several node tiles (nn 16, 32), several row slices merged with global
# atomics (few lanes and nodes), several lanes per CTA (nn 1), n_bins 256,
# two_k 4, feature tiles that leave threads idle (d 33, 65, 200), row counts
# that are no multiple of any block (primes)
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 4, 8, 2), (150, 20011, 128, 16, 32, 2), (1, 5, 1, 1, 2, 2),
    (4, 70001, 33, 2, 32, 4), (2, 3000, 65, 32, 16, 2),
    (3, 100003, 128, 16, 32, 2), (12, 65537, 128, 1, 32, 2),
    (2, 30011, 128, 4, 256, 2), (5, 40009, 200, 3, 255, 2)])
def test_hist_int_kernel_bitwise_and_counted(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, True, seed=n)
    before = TH.launches
    got = TH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


# the GBT levels (3 lanes x 1-2 nodes: every lane and node in one CTA, many
# slices summed in order), a tiled many-lane level (150 lanes x 16 nodes),
# ragged d (no 16-byte code copies), two_k 4 and n_bins 255
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 2, 32, 2), (3, 200003, 128, 1, 32, 2), (12, 50000, 40, 8, 32, 2),
    (3, 262147, 128, 2, 32, 2), (150, 20011, 128, 16, 32, 2),
    (3, 30011, 33, 2, 32, 2), (2, 20011, 64, 2, 255, 4)])
def test_hist_f32_kernel_within_tolerance_and_repeatable(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, False, seed=n)
    a = TH.hist_level(local, gh, binned, nn, n_bins)
    b = TH.hist_level(local, gh, binned, nn, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins)
    tol = TH.f32_tolerance(TH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))
    assert bool(((a - ref).abs() <= tol).all())


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("L, nn, d, n_bins", [(3, 4, 6, 8), (150, 32, 128, 32),
                                              (2, 1, 1, 2)])
def test_split_scan_kernel_bitwise_on_integer_hists(K, L, nn, d, n_bins):
    rng = np.random.default_rng(L * nn + K)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    hg[0, 0] = 0.0
    hh[0, 0] = 0.0                              # an empty node
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = np.ones((L, d), np.float32)
    mask[-1, 0] = 0.0
    args = [torch.from_numpy(a).cuda() for a in (hg, hh, G, H, mask)]
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        before = TS.launches
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        assert TS.launches == before + 1
        ref = TS.split_scan_torch(*args, n_bins, *params)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("params", [(1.0, 0.0, 0.0, 1.0), (1.0, 0.5, 0.1, 1.0)])
def test_split_scan_kernel_on_float_hists_within_tolerance(params):
    L, nn, d, n_bins, n = 3, 4, 128, 32, 200003
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, 2, False, seed=5)
    gh[:, 1] = gh[:, 1].abs()                   # hessians are not negative
    hist = TH.hist_level(local, gh, binned, nn, n_bins).reshape(
        L, nn, 2, n_bins + 1, d).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, d), device="cuda")
    mask[-1, 3] = 0.0
    args = (hg, hh, G, H, mask, n_bins, *params)
    got = TS.split_scan(*args)
    again = TS.split_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    agree = TS.float_agreement(got, *args)
    assert agree["ok"], agree


@pytest.mark.parametrize("L, n, d", [(1, 37, 5), (150, 4099, 128), (3, 100003, 7)])
def test_row_select_kernel_bitwise_and_counted(L, n, d):
    rng = np.random.default_rng(n)
    binned = torch.from_numpy(rng.integers(0, 33, (n, d)).astype(np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(-3, d + 3, (L, n)).astype(np.int32)).cuda()
    before = TR.launches
    got = TR.row_select_lanes(binned, idx)
    torch.cuda.synchronize()
    assert TR.launches == before + 1
    assert torch.equal(got, TR.row_select_lanes_torch(binned, idx))


def _route_plan(path, L, n, d):
    """The plan of ``path`` at this shape, whichever routing.plan picks."""
    p = TR.plan(L, n, d)
    if p.path == path:
        return p
    if path == "direct":
        return TR.RoutePlan("direct", TR.THREADS, 0, TR.THREADS,
                            -(-n // TR.THREADS), 0)
    stride = d | 1
    rows = 64 if 64 * stride * 4 <= 200 * 1024 else 32
    return TR.RoutePlan("tile", rows, stride, TR.THREADS, -(-n // rows),
                        rows * stride * 4)


# both paths on the same inputs: ragged rows (no multiple of 32, 64 or 256),
# d 5 / 128 / 866, negative and out-of-range idx, and every row of a lane
# selecting one feature (the shared-memory bank-conflict case of the tile path)
@pytest.mark.parametrize("path", ["tile", "direct"])
@pytest.mark.parametrize("L, n, d", [(150, 4099, 128), (3, 100003, 128),
                                     (50, 65, 5), (7, 1001, 866), (1, 37, 128)])
@pytest.mark.parametrize("one_feature", [False, True])
def test_row_select_paths_bitwise(path, L, n, d, one_feature):
    rng = np.random.default_rng(L * n + d)
    binned = rng.integers(0, 33, (n, d)).astype(np.int32)
    if one_feature:
        idx = np.repeat((np.arange(L) * 7 % d)[:, None], n, axis=1).astype(np.int32)
    else:
        idx = rng.integers(-3, d + 3, (L, n)).astype(np.int32)
        idx[:, :3] = [-1, d, -(2 ** 31)]
    b, i = (torch.from_numpy(a).cuda() for a in (binned, idx))
    p = _route_plan(path, L, n, d)
    before = TR.launches
    got = TR.launch(b, i, p)
    torch.cuda.synchronize()
    assert TR.launches == before + 1
    assert torch.equal(got, TR.row_select_lanes_torch(b, i))


def _scan_case(L, nn, K, d, n_bins, seed, special=False, miss="filled"):
    """Integer-valued histograms with an empty node, a masked feature, a
    fully masked lane, exact ties (feature 1 a copy of feature 0, node 1 of
    node 0) and, where ``special``, NaN and +-inf cells.  ``miss``: the
    missing-value bin "filled", "empty" (+0 or -0 in every feature) or
    empty in every other feature ("half": warps with both kinds)."""
    rng = np.random.default_rng(seed)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    hg[0, 0] = 0.0
    hh[0, 0] = 0.0
    if d > 1:
        hg[..., 1, :] = hg[..., 0, :]
        hh[..., 1, :] = hh[..., 0, :]
    if nn > 2:
        hg[:, 2] = hg[:, 1]
        hh[:, 2] = hh[:, 1]
    if miss != "filled":
        step = 2 if miss == "half" else 1
        hg[..., ::step, n_bins] = 0.0
        hh[..., ::step, n_bins] = 0.0
        hg[..., ::3 * step, n_bins] = -0.0
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    if special:
        for v in (np.nan, np.inf, -np.inf):
            at = tuple(rng.integers(0, s, 40) for s in hg.shape)
            hg[at] = v
            hh[tuple(np.roll(a, 1) for a in at)] = v
    mask = np.ones((L, d), np.float32)
    mask[-1, 0] = 0.0
    if L > 2:
        mask[1] = 0.0
    return [torch.from_numpy(a).cuda() for a in (hg, hh, G, H, mask)]


def _same(a, b):
    """Equal, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


# K 1 and 2, B odd (33) and even (34), d wider than a CTA's feature tile
# (1100: feature tiles in turn), NaN and +-inf, ties, a fully masked lane,
# the missing-value bin filled or empty (+-0: the kernel's shortcut)
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n_bins", [32, 33])
@pytest.mark.parametrize("L, nn, d", [(3, 4, 128), (2, 3, 1100), (4, 2, 6)])
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("miss", ["filled", "empty"])
def test_split_scan_cases_bitwise(K, n_bins, L, nn, d, special, miss):
    args = _scan_case(L, nn, K, d, n_bins, seed=L * d + K + n_bins, special=special,
                      miss=miss)
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        before = TS.launches
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        assert TS.launches == before + 1
        ref = TS.split_scan_torch(*args, n_bins, *params)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and _same(g, r)


def _scan_variants(p, K):
    """plan() and the same launch with the histograms read where they lie,
    and with 1-4 threads sharing each feature's candidates."""
    P, FT = p.blocks_per_cta, p.feats
    out = [p, p._replace(staged=False, stride=0,
                         smem=TS._scan_smem(False, P, FT, K, 0, p.groups))]
    for S in (1, 2, 3, 4):
        if P * FT * S <= TS.SCAN_MAX_THREADS:
            out.append(p._replace(groups=S, threads=P * FT * S,
                                  smem=TS._scan_smem(p.staged, P, FT, K, p.stride, S)))
    return out


# every launch shape gives the same bits: staged or not, 1-4 threads a
# feature; K = 4 with 256 bins does not fit shared memory (the plan reads the
# histograms where they lie); K = 3 keeps its running sums in shared memory;
# alpha 0 (the threshold left out) and not
@pytest.mark.parametrize("L, nn, K, d, n_bins", [(3, 4, 1, 128, 32), (2, 3, 2, 1100, 33),
                                                  (2, 2, 4, 16, 255), (2, 2, 3, 40, 32),
                                                  (150, 32, 1, 128, 32)])
@pytest.mark.parametrize("params", [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)])
@pytest.mark.parametrize("miss", ["filled", "empty", "half"])
def test_split_scan_launch_shapes_bitwise(L, nn, K, d, n_bins, params, miss):
    args = _scan_case(L, nn, K, d, n_bins, seed=K * d, special=True, miss=miss)
    ref = TS.split_scan_torch(*args, n_bins, *params)
    for q in _scan_variants(TS.plan(L, nn, K, d, n_bins), K):
        got = TS.launch(*args, n_bins, *params, q)
        torch.cuda.synchronize()
        assert all(g.dtype == r.dtype and _same(g, r) for g, r in zip(got, ref)), q


@pytest.mark.parametrize("L, nn, d", [(3, 4, 128), (2, 3, 1100)])
def test_split_scan_float_hists_repeatable(L, nn, d):
    n_bins, n = 32, 50021
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, 2, False, seed=d)
    gh[:, 1] = gh[:, 1].abs()
    hist = TH.hist_level(local, gh, binned, nn, n_bins).reshape(
        L, nn, 2, n_bins + 1, d).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, d), device="cuda")
    args = (hg, hh, G, H, mask, n_bins, 1.0, 0.0, 0.0, 1.0)
    got = TS.split_scan(*args)
    again = TS.split_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert TS.float_agreement(got, *args)["ok"]
    # the same bits from every launch shape: one chain of adds per left sum
    for q in _scan_variants(TS.plan(L, nn, 1, d, n_bins), 1):
        other = TS.launch(*args, q)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, other)), q



# -- channel tiles: past the channels one CTA holds (44 on the int8 path, 54
# on the float one at 33 bins) the histogram tiles them; a tile may hold
# fewer than CT, and another plan of the same level gives the same bits

@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 20011, 128, 4, 32, 44), (150, 4099, 128, 16, 32, 200),
    (2, 30011, 40, 2, 32, 134), (1, 65537, 128, 1, 32, 60)])
def test_hist_int_kernel_channel_tiles_bitwise(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, True, seed=n + two_k)
    p = TH.plan(L, n, d, nn, two_k, n_bins, True)
    assert p["chan_tiles"] > 1
    before = TH.launches
    got = TH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 20011, 128, 4, 32, 200), (150, 4099, 128, 16, 32, 60),
    (1, 65537, 33, 1, 32, 134), (3, 30011, 128, 2, 32, 54)])
def test_hist_f32_kernel_channel_tiles_within_tolerance(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, False, seed=n + two_k)
    p = TH.plan(L, n, d, nn, two_k, n_bins, False)
    assert p["chan_tiles"] > 1
    a = TH.hist_level(local, gh, binned, nn, n_bins)
    b = TH.hist_level(local, gh, binned, nn, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins)
    tol = TH.f32_tolerance(TH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))
    assert bool(((a - ref).abs() <= tol).all())
    # each cell adds its slice's rows in order whatever the channel tiles:
    # a plan with fewer channels a CTA and the same row slices gives the
    # same bits
    q = TH.finish_plan({**{k: p[k] for k in ("G", "NT", "FT", "threads", "R")},
                        "CT": max(1, p["CT"] // 2)}, L, n, d, nn, two_k, n_bins, False)
    q.update({k: p[k] for k in ("slices", "rows_per_slice", "merge")})
    c = TH.launch(local, gh, binned, nn, n_bins, False, q)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


# K2 at K >= 24: the plan reads the histograms where they lie (unstaged)
@pytest.mark.parametrize("K, L, nn, d", [(24, 3, 4, 128), (100, 3, 4, 128),
                                        (30, 150, 16, 16)])
@pytest.mark.parametrize("miss", ["filled", "empty"])
def test_split_scan_unstaged_many_classes_bitwise(K, L, nn, d, miss):
    n_bins = 32
    assert not TS.plan(L, nn, K, d, n_bins).staged
    args = _scan_case(L, nn, K, d, n_bins, seed=K + L, special=False, miss=miss)
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        ref = TS.split_scan_torch(*args, n_bins, *params)
        assert all(g.dtype == r.dtype and _same(g, r) for g, r in zip(got, ref))

# -- a bucketize slot past shared memory: its own launch, splits read from
# global memory by a binary search

@pytest.mark.parametrize("n_splits", [4097, 5000, 12288])
@pytest.mark.parametrize("track_nulls, track_invalid", [(True, True), (False, False)])
def test_bucketize_kernel_past_shared_memory_bitwise(n_splits, track_nulls, track_invalid):
    s_np = np.sort(np.random.default_rng(n_splits).normal(size=n_splits)).astype(np.float32)
    s_np[0], s_np[-1] = -np.inf, np.inf
    x = torch.from_numpy(_values(3001, s_np[:40], seed=n_splits)).cuda()
    x[40:80] = torch.from_numpy(s_np[1000:1040]).cuda()       # on a split
    s = torch.from_numpy(s_np).cuda()
    before = TKE.bucketize_launches
    got = TKE.bucketize_right_encode(x, s, track_nulls, track_invalid)
    torch.cuda.synchronize()
    assert TKE.bucketize_launches == before + 1
    assert torch.equal(got, TKE.bucketize_right_encode_torch(x, s, track_nulls,
                                                             track_invalid))


@pytest.mark.parametrize("where", [0, 3, 6])
def test_encode_slots_with_a_5000_split_slot_bitwise(where):
    """The oversized slot launches alone; the others keep shared memory."""
    specs, inputs = slot_case(1024, 7, "cuda", 6)
    big = np.sort(np.random.default_rng(1).normal(size=5000)).astype(np.float32)
    specs.insert(where, TKE.bucketize_slot(big, True, True))
    inputs.insert(where, torch.from_numpy(_values(1024, big[:30], seed=2)).cuda())
    table = TKE.plan_slots(specs)
    assert (where, where + 1) in table.chunks
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + len(table.chunks)
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


# -- K1 int8 past 2**31 // 127 rows: the guard follows the data

def test_hist_int_kernel_past_16_9m_rows_bitwise():
    n = (2 ** 31 - 1) // 127 + 1001
    g = torch.Generator(device="cuda").manual_seed(0)
    binned = torch.randint(0, 33, (n, 3), generator=g, device="cuda", dtype=torch.int32)
    local = torch.randint(-1, 2, (1, n), generator=g, device="cuda", dtype=torch.int32)
    w = torch.randint(0, 2, (n,), generator=g, device="cuda", dtype=torch.int8)
    gh = torch.stack([-w, w])[None].contiguous()
    before = TH.launches
    got = TH.hist_level(local, gh, binned, 2, 32, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    assert torch.equal(got, TH.hist_level_torch(local, gh, binned, 2, 32, int_exact=True))


# -- the linear fits on the card against the port on the CPU (TF32 off)

def _linear_data(n=4096, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ rng.normal(size=d)) / np.sqrt(d)))) \
        .astype(np.float32)
    fold = rng.permutation(n) % 3
    tw = np.stack([(fold != f).astype(np.float32) for f in range(3)])
    return x, y, tw, 1.0 - tw


@pytest.mark.parametrize("fam", ["lr", "svc"])
def test_linear_sweeps_on_the_card_equal_the_cpu(fam):
    from transmogrifai_tpu_torch.evaluators.metrics import au_pr
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.models.svm import LinearSVC

    x, y, tw, vw = _linear_data()
    if fam == "lr":
        est, grids = LogisticRegression(), [{"reg_param": r, "elastic_net": e}
                                            for r in (0.001, 0.1) for e in (0.0, 0.5)]
    else:
        est, grids = LinearSVC(), [{"reg_param": r} for r in (0.01, 0.1)]
    card = est.cv_sweep(x, y, tw, vw, grids, au_pr, torch.device("cuda"))
    cpu = est.cv_sweep(x, y, tw, vw, grids, au_pr, torch.device("cpu"))
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    for g in grids:
        a = est.copy().set_params(**g)._fit_arrays(x, y, tw[0], torch.device("cuda"))
        b = est.copy().set_params(**g)._fit_arrays(x, y, tw[0], torch.device("cpu"))
        np.testing.assert_allclose(a.coef, b.coef, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.intercept, b.intercept, rtol=1e-4, atol=1e-4)


# -- the wide pipeline from raw columns: the training plan and the checker -----

RAW_CUT = dict(n_real=6, n_bucketized=3, n_pick=4, n_levels=30, n_binary=2)


def _raw(n: int, device: str):
    """The wide pipeline at a cut, trained on ``device``; (model, checker,
    selector, dataset, vector feature)."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import make_data, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name

    cols, schema = make_data(n, **RAW_CUT)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema)
    ds = T.Dataset.from_features(cols, ftypes)
    model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device=device)
    return model, chk, sel, ds, chk.inputs[1]


@pytest.mark.parametrize("n", [3000, 20011])
def test_training_plan_vector_on_the_card_equals_the_plain_path(n):
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    model, _, _, ds, vec = _raw(n, "cpu")
    TKE.reset_launch_counts()
    card = transform_dag(ds, [vec], model.fitted, torch.device("cuda"))[vec.name]
    counts = TKE.launch_counts()
    cpu = transform_dag(ds, [vec], model.fitted, torch.device("cpu"))[vec.name]
    assert card.data.shape == cpu.data.shape
    assert card.data.tobytes() == cpu.data.tobytes()
    assert card.meta.to_dict() == cpu.meta.to_dict()
    assert counts["encode_slots"] == 1 and counts["onehot_codes"] == 0


@pytest.mark.parametrize("params", [{}, {"correlation_type": "spearman"},
                                    {"min_correlation": 0.02}])
def test_sanity_checker_on_the_card_equals_the_cpu(params):
    from transmogrifai_tpu_torch import Dataset, FeatureBuilder
    from transmogrifai_tpu_torch.checkers.sanity import SanityChecker
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    model, _, _, ds, vec = _raw(3000, "cpu")
    col = transform_dag(ds, [vec], model.fitted, torch.device("cpu"))[vec.name]
    fits = []
    for dev in ("cuda", "cpu"):
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        v = FeatureBuilder.OPVector("v").extract_field().as_predictor()
        chk = SanityChecker(**params)
        label.transform_with(chk, v)
        fits.append(chk.fit(Dataset({"label": ds["label"], "v": col}), device=dev))
    card, cpu = (f.summary for f in fits)
    assert fits[0].kept_indices == fits[1].kept_indices
    assert card.dropped == cpu.dropped
    for a, b in zip(cpu.stats, card.stats):
        for k in ("mean", "variance", "min", "max", "corr_label", "cramers_v",
                  "max_rule_confidence", "support"):
            x, y = getattr(a, k), getattr(b, k)
            if x is None:
                assert y is None
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=f"{a.name} {k}")
    np.testing.assert_allclose(card.correlations_feature, cpu.correlations_feature,
                               rtol=0, atol=1e-5)


def test_training_from_raw_columns_on_the_card_equals_the_cpu():
    TKE.reset_launch_counts()
    cm, cchk, csel, _, _ = _raw(3000, "cuda")
    assert TKE.launch_counts()["encode_slots"] == 1
    pm, pchk, psel, _, _ = _raw(3000, "cpu")

    def states(m):
        return sorted((type(t).__name__, [f.name for f in t.inputs],
                       repr(getattr(t, "fills", None)), getattr(t, "vocabs", None),
                       getattr(t, "splits", None))
                      for t in m.fitted.values() if not hasattr(t, "summary"))

    assert states(cm) == states(pm)
    assert cm.fitted[cchk.uid].kept_indices == pm.fitted[pchk.uid].kept_indices
    a, b = cm.fitted[csel.uid], pm.fitted[psel.uid]
    assert a.summary.best_grid == b.summary.best_grid
    for x, y in zip(a.summary.validation_results, b.summary.validation_results):
        np.testing.assert_allclose(x.metric_values, y.metric_values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.model.coef, b.model.coef, rtol=1e-4, atol=1e-5)


# -- the families: text, dates, lists, multi-pick lists, geolocations ------------

FAMILIES = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_families")


def _families(n: int, device: str):
    """The families pipeline trained on ``device``: (model, selector,
    checker, dataset, profile)."""
    import transmogrifai_tpu_torch as T
    from torch_families_data import families_pipeline, make_families
    from transmogrifai_tpu_torch.types import feature_type_by_name

    cols, schema = make_families(n, seed=0)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = families_pipeline(T, ftypes, schema)
    ds = T.Dataset.from_features(cols, ftypes)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    return wf.train(device=device), sel, chk, ds, wf.last_train_profile


def test_families_native_library_builds_and_takes_every_hash():
    from torch_families_data import make_families
    from transmogrifai_tpu_torch import native

    assert native.warmup(), native.BUILD_ERROR
    cols, _ = make_families(3000, seed=1)
    native.reset_path_counts()
    block, _ = native.tokenize_hash_count(cols["review"], 512)
    lists = native.hash_count_block(cols["keywords"], 512)
    counts = native.path_counts()
    assert counts["tokenize_hash_count.native"] == 1
    assert counts["hash_count_block.native"] >= 1
    assert not [k for k in counts if k.endswith(".python")], counts
    saved = native._LIB
    try:  # the Python path on the same inputs gives the same bits
        native._LIB = None
        assert native.tokenize_hash_count(cols["review"], 512)[0].tobytes() == block.tobytes()
        assert native.hash_count_block(cols["keywords"], 512).tobytes() == lists.tobytes()
    finally:
        native._LIB = saved


def test_families_training_on_the_card_equals_the_record():
    """At the record's 4096 rows: fitted states and the training vector
    equal the JAX package's record; the pick lists' two slots in one encode
    launch; LR within 1e-4 of the CPU train (the card's float32 sums run in
    another order)."""
    import json

    from torch_families_data import fitted_states, vector_digest
    from transmogrifai_tpu_torch import native
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    with open(os.path.join(FAMILIES, "states.json")) as fh:
        states = json.load(fh)
    native.reset_path_counts()
    TKE.reset_launch_counts()
    cm, csel, cchk, ds, prof = _families(states["rows"], "cuda")
    launches = TKE.launch_counts()
    assert launches["encode_slots"] == 1 and launches["encode_slots.slots"] == 2
    assert not [k for k in native.path_counts() if k.endswith(".python")]
    assert json.loads(json.dumps(fitted_states(cm))) == states["fitted"]
    vec = cchk.inputs[1]
    card = transform_dag(ds, [vec], cm.fitted, torch.device("cuda"))[vec.name]
    assert vector_digest(card.data) == states["vector"]
    pm, psel, _, _, _ = _families(states["rows"], "cpu")
    a, b = cm.fitted[csel.uid], pm.fitted[psel.uid]
    assert a.summary.best_grid == b.summary.best_grid
    for x, y in zip(a.summary.validation_results, b.summary.validation_results):
        np.testing.assert_allclose(x.metric_values, y.metric_values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.model.coef, b.model.coef, rtol=1e-4, atol=1e-5)


def test_families_serving_plan_on_the_card_equals_the_cpu():
    """The JAX package's saved model on the card: one encode launch (2
    slots) per batch; records equal to the CPU plan's and, within 1e-12,
    to the JAX serving plan's record (another machine's float64 head)."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(FAMILIES, "records.json")) as fh:
        rec = json.load(fh)
    model = WorkflowModel.load(FAMILIES)
    plan, cpu_plan = model.serving_plan(), model.serving_plan(device="cpu")
    for b in rec["batches"]:
        TKE.reset_launch_counts()
        got = plan.score(b["records"])
        assert TKE.launch_counts()["encode_slots"] == 1
        assert TKE.launch_counts()["encode_slots.slots"] == 2
        assert got == cpu_plan.score(b["records"])
        name = rec["prediction"]
        dev = max(abs(g[name]["probability_1"] - w[name]["probability_1"])
                  for g, w in zip(got, b["scored"]))
        assert dev <= 1e-12, dev


# -- the left-closed bucketize slot (NumericBucketizer) -------------------------------

@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
@pytest.mark.parametrize("n_slots", [1, 8])
def test_left_closed_slots_bitwise_and_counted(n, n_slots):
    from torch_encode_cases import left_slot_case

    specs, inputs = left_slot_case(n, n + n_slots, "cuda", n_slots)
    table = TKE.plan_slots(specs)
    before = (TKE.encode_slots_launches, TKE.left_closed_launches, TKE.left_closed_slots)
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert (TKE.encode_slots_launches, TKE.left_closed_launches,
            TKE.left_closed_slots) == (before[0] + 1, before[1] + 1, before[2] + n_slots)
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


@pytest.mark.parametrize("n, offset, pad", [(37, 1, 3), (1024, 0, 0), (997, 2, 4)])
def test_left_closed_slots_mixed_into_a_table_bitwise(n, offset, pad):
    from torch_encode_cases import left_slot_case

    specs, inputs = slot_case(n, 5, "cuda", 12)
    lspecs, linputs = left_slot_case(n, 6, "cuda", 9)
    for k, (s, x) in enumerate(zip(lspecs, linputs)):
        specs.insert(2 * k, s)
        inputs.insert(2 * k, x)
    table = TKE.plan_slots(specs)
    w = table.width
    buf = torch.full((n, offset + w + pad), 7.0, device="cuda")
    TKE.encode_slots(inputs, table, buf[:, offset:offset + w])
    torch.cuda.synchronize()
    assert torch.equal(buf[:, offset:offset + w], TKE.encode_slots_torch(inputs, table))
    assert bool((buf[:, :offset] == 7.0).all()) and bool((buf[:, offset + w:] == 7.0).all())


@pytest.mark.parametrize("n_splits", [4097, 5000])
@pytest.mark.parametrize("track_nulls, track_invalid", [(True, True), (False, False),
                                                        (True, False)])
def test_left_closed_slot_past_shared_memory_bitwise(n_splits, track_nulls, track_invalid):
    from torch_encode_cases import left_slot_case

    specs, inputs = left_slot_case(3001, n_splits, "cuda", 1, n_splits=n_splits)
    specs = [specs[0]._replace(track_nulls=track_nulls, track_invalid=track_invalid,
                               width=TKE.bucket_width(n_splits, track_nulls, track_invalid))]
    table = TKE.plan_slots(specs)
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


def test_numeric_bucketizer_on_the_card_equals_the_cpu():
    from transmogrifai_tpu_torch.ops.scalers import NumericBucketizer
    from torch_encode_cases import left_slot_case

    _, [x] = left_slot_case(4096, 1, "cpu", 1)
    for kw in ({}, {"splits": (-1.0, 0.0, 2.0), "track_invalid": True},
               {"splits": (float("-inf"), 0.5, float("inf")), "track_nulls": False}):
        b = NumericBucketizer(**kw)
        card = b.device_transform(x.cuda())
        torch.cuda.synchronize()
        assert torch.equal(card.cpu(), b.device_transform(x))


def test_dsl_pipeline_on_the_card_equals_the_cpu():
    """The wide table with the DSL's features at a cut, trained on the card:
    one flush encodes every slot (the left-closed ones among them) in one
    launch, the training vector bitwise the CPU's, LR CV within 1e-4, and
    the serving plan's records equal the CPU plan's."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import dsl_pipeline, make_data, score_column
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    shape = dict(n_real=28, n_bucketized=3, n_pick=5, n_levels=30, n_binary=2)
    cols, schema = make_data(3000, seed=4, **shape)
    cols["score"] = score_column(3000, seed=4)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ftypes["score"] = T.types.RealNN
    ds = T.Dataset.from_features(cols, ftypes)
    models = {}
    for dev in ("cpu", "cuda"):
        label, sel, chk, pred = dsl_pipeline(T, ftypes, schema)
        TKE.reset_launch_counts()
        models[dev] = (T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
                       .train(device=dev), sel, chk, pred)
        if dev == "cuda":
            assert TKE.encode_slots_launches == 1 and TKE.left_closed_slots == 8
            assert TKE.slots_encoded == 3 + 8 + 5
    (cm, csel, cchk, cpred), (gm, gsel, gchk, gpred) = models["cpu"], models["cuda"]
    for m, chk, dev in ((cm, cchk, "cpu"), (gm, gchk, "cuda")):
        models[dev] = models[dev] + (transform_dag(ds, [chk.inputs[1]], m.fitted,
                                                   torch.device("cpu"))[chk.inputs[1].name],)
    assert models["cpu"][4].data.tobytes() == models["cuda"][4].data.tobytes()
    for a, b in zip(cm.fitted[csel.uid].summary.validation_results,
                    gm.fitted[gsel.uid].summary.validation_results):
        np.testing.assert_allclose(b.metric_values, a.metric_values, rtol=0, atol=1e-4)
    recs = [{k: cols[k][i] for k in cols if k != "label"} for i in range(256)]
    plan = gm.serving_plan()
    TKE.reset_launch_counts()
    got = plan.score(recs)
    assert TKE.encode_slots_launches == 1 and TKE.left_closed_slots == 8
    assert got == gm.serving_plan(device="cpu").score(recs)


@pytest.mark.parametrize("bins", [100, 7])
def test_filter_histograms_on_the_card_equal_the_cpu(bins):
    from transmogrifai_tpu_torch.filters.distribution import numeric_histograms

    rng = np.random.default_rng(bins)
    v = (rng.normal(size=(20_011, 9)) * 100).astype(np.float32)
    v[rng.random(v.shape) < 0.1] = np.nan
    v[:5, 1], v[5:9, 1], v[9:20, 2] = np.inf, -np.inf, 1e12
    v[:, 3] = 7.0
    v[:, 4] = np.nan
    lo = np.nan_to_num(np.nanmin(np.where(np.isinf(v), np.nan, v), axis=0)).astype(np.float32)
    hi = np.nan_to_num(np.nanmax(np.where(np.isinf(v), np.nan, v), axis=0)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (v, lo, hi)]
    want = numeric_histograms(*args, bins)
    got = numeric_histograms(*[a.cuda() for a in args], bins)
    assert torch.equal(got.cpu(), want)


def test_maps_training_on_the_card_equals_the_record():
    """The maps table with its raw feature filter at the record's rows: the
    filter's record, fitted states and training vector equal the JAX
    package's (fixtures/training_maps)."""
    import json

    import transmogrifai_tpu_torch as T
    from torch_maps_data import (
        fitted_states,
        make_maps,
        make_scoring,
        maps_filter,
        maps_pipeline,
        vector_digest,
    )
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    record = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_maps")
    with open(os.path.join(record, "states.json")) as fh:
        states = json.load(fh)
    with open(os.path.join(record, "rff.json")) as fh:
        rff = json.load(fh)
    cols, schema = make_maps(states["rows"], seed=states["seed"])
    scols, sschema = make_scoring(states["scoring_rows"], seed=states["scoring_seed"])
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    sds = T.Dataset.from_features(scols, {s["name"]: ftypes[s["name"]] for s in sschema})
    label, _, chk, pred = maps_pipeline(T, ftypes, schema)
    model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .with_raw_feature_filter(maps_filter(T, sds)).train(device="cuda")
    assert json.loads(json.dumps(model.rff_summary.to_dict())) == rff["results"]
    assert json.loads(json.dumps(fitted_states(model))) == states["fitted"]
    vec = chk.inputs[1]
    got = transform_dag(ds, [vec], model.fitted, torch.device("cuda"))[vec.name].data
    assert vector_digest(got) == states["vector"]


def _embedding_docs(n: int = 400):
    from torch_text_data import make_text

    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.ops import text
    from transmogrifai_tpu_torch.types import Text

    cols, _ = make_text(n, seed=0)
    toks = text.TextTokenizer().transform_columns(
        [Column.from_values(Text, cols["review"])], None)
    return text.StopWordsRemover().transform_columns([toks], None)


@pytest.mark.parametrize("batch,num_neg", [(256, 4), (100, 2)])
def test_word2vec_step_loop_on_the_card_equals_the_cpu(batch, num_neg):
    """The same draws (the CPU generator's, fed to the card too) and the
    same epochs: the card's vectors within 1e-6 of the CPU's, and bitwise
    from one run to the next (index_put_ sums repeated rows in order)."""
    from transmogrifai_tpu_torch.ops import embeddings as E

    docs = _embedding_docs()
    w_in, w_out = E.draw_word2vec_init(42, 200, 16, torch.device("cpu"))
    real = E.draw_word2vec_init
    E.draw_word2vec_init = lambda s, v, d, dev: (w_in[:v].to(dev, copy=True),
                                                  w_out[:v].to(dev, copy=True))
    try:
        fits = {}
        for dev in ("cpu", "cuda", "cuda"):
            est = E.Word2Vec(embedding_dim=16, max_vocab=200, epochs=2, batch_size=batch,
                             num_negatives=num_neg)
            E.reset_launch_counts()
            m = est.fit_columns([docs], None, torch.device(dev))
            fits.setdefault(dev, []).append(m.vectors)
            assert E.launch_counts()["skipgram_epochs"] == 2
    finally:
        E.draw_word2vec_init = real
    np.testing.assert_allclose(fits["cuda"][0], fits["cpu"][0], rtol=0, atol=1e-6)
    assert fits["cuda"][0].tobytes() == fits["cuda"][1].tobytes()


def test_lda_on_the_card_equals_the_cpu():
    """LDA's EM and LDAModel's E-step on the card, from the same initial
    draw as the CPU: the topic-word matrix within 1e-4 of the CPU's,
    relative (the tolerance the JAX package's record is held to: the card's
    products and digamma round otherwise, and five EM rounds carry it to
    ~1.3e-5), and the topic proportions within 1e-5."""
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.types import TextList

    docs = _embedding_docs()
    lam0 = E.draw_lda_init(42, 4, 200, torch.device("cpu"))
    real = E.draw_lda_init
    E.draw_lda_init = lambda s, k, v, dev: lam0[:, :v].to(dev, copy=True)
    try:
        models = {dev: E.LDA(k=4, max_vocab=200, max_iter=5).fit_columns(
            [docs], None, torch.device(dev)) for dev in ("cpu", "cuda")}
    finally:
        E.draw_lda_init = real
    np.testing.assert_allclose(models["cuda"].topic_word, models["cpu"].topic_word, rtol=1e-4)
    m = models["cpu"]
    T.FeatureBuilder.of("d", TextList).extract_field().as_predictor().transform_with(m)
    ds = T.Dataset({"d": docs})
    got = m.transform(ds, device="cuda")[m.output_name].data
    want = m.transform(ds, device="cpu")[m.output_name].data
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# -- workflow-level CV: the fold transform, LOCO --------------------------------

def _fold_maps(n: int):
    """The wide cut's ``before`` dataset, ``during`` stages and 3 folds'
    fitted maps (fitted on the CPU), and the selector's vector name."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import make_data, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.dag import cut_dag
    from transmogrifai_tpu_torch.workflow.fit import fit_stage_list

    cols, schema = make_data(n, **RAW_CUT)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema, 3)
    ds = T.Dataset.from_features(cols, ftypes)
    before, during, _ = cut_dag([label, pred])
    ds_before = fit_stage_list(ds, before, {}, device="cpu")
    maps = []
    for f in range(3):
        ff, copies = {}, [s.copy() for s in during]
        fit_stage_list(ds_before.take(np.flatnonzero(np.arange(n) % 3 != f)), copies, ff,
                       device="cpu")
        maps.append({c.uid: ff.get(c.uid, c) for c in copies})
    return ds_before, during, maps, sel.inputs[1].name


@pytest.mark.parametrize("n", [3000, 20011])
def test_fold_transform_one_launch_on_the_card_equals_the_plain_path(n):
    """Every fold's encode slots in ONE encode_slots launch on the card,
    each fold's outputs bitwise the CPU plan's (encode_slots_torch)."""
    from transmogrifai_tpu_torch.workflow.plan import fused_fold_transforms

    ds, during, maps, vec = _fold_maps(n)
    slots = sum(1 for m in maps for r in m.values()
                if type(r).__name__ == "DecisionTreeNumericBucketizerModel" and r.should_split)
    TKE.reset_launch_counts()
    card = fused_fold_transforms(ds, during, maps, torch.device("cuda"))
    counts = TKE.launch_counts()
    cpu = fused_fold_transforms(ds, during, maps, torch.device("cpu"))
    assert counts["encode_slots"] == 1 and counts["encode_slots.slots"] == slots > 3
    for c, p in zip(card, cpu):
        for s in during:
            assert c[s.output_name].data.tobytes() == p[s.output_name].data.tobytes()
        assert c[vec].meta.to_dict() == p[vec].meta.to_dict()


@pytest.mark.parametrize("family", ["lr", "mlp"])
def test_loco_on_the_card_equals_the_cpu(family):
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.models.logistic import LogisticRegressionModel
    from transmogrifai_tpu_torch.models.mlp import MLPClassifierModel

    rng = np.random.default_rng(7)
    d = 300
    x = rng.normal(size=(512, d))
    x[rng.random(x.shape) < 0.8] = 0.0
    if family == "lr":
        model = LogisticRegressionModel(coef=rng.normal(size=d) / 10, intercept=0.2)
    else:
        model = MLPClassifierModel(classes=np.arange(2.0), weights=[
            (rng.normal(size=(d, 10)) / 10, rng.normal(size=10)),
            (rng.normal(size=(10, 2)), rng.normal(size=2))])
    out = {}
    for dev in ("cuda", "cpu"):
        t = RecordInsightsLOCO(model, top_k=20, max_rows_per_batch=4096, device=dev)
        out[dev] = [RecordInsightsLOCO.parse(m)
                    for m in t.transform_columns([Column.vector(x)], None).data]
        if dev == "cuda":
            assert t.last_profile["device_ms"] is not None
    for a, b in zip(out["cuda"], out["cpu"]):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)


def test_loco_group_sums_repeat_on_the_card():
    """Groups of many active slots: two runs on the card give the same bits
    (each group adds its diffs in slot order, no racing additions)."""
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.models.logistic import LogisticRegressionModel
    from transmogrifai_tpu_torch.utils.vector_metadata import (
        VectorColumnMetadata,
        VectorMetadata,
    )

    rng = np.random.default_rng(11)
    d = 256
    x = rng.normal(size=(512, d))
    x[rng.random(x.shape) < 0.3] = 0.0
    meta = VectorMetadata("vec", [
        VectorColumnMetadata(f"txt{i // 64}", "Text", grouping="hash", index=i)
        for i in range(d)])
    model = LogisticRegressionModel(coef=rng.normal(size=d), intercept=0.1)
    runs = [RecordInsightsLOCO(model, top_k=4, meta=meta, device="cuda")
            .transform_columns([Column.vector(x, meta)], None).data for _ in range(2)]
    assert list(runs[0]) == list(runs[1])


# -- local scoring, streaming, the continual refit, a resumed sweep -------------

def test_local_scorer_and_streaming_score_launch_once_a_batch(tmp_path):
    """score_function and STREAMING_SCORE on the card: one encode launch of
    40 slots a batch, scores bitwise the CPU's, offsets committed."""
    import json

    from transmogrifai_tpu_torch import Workflow, WorkflowModel
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.params import OpParams
    from transmogrifai_tpu_torch.readers import (JsonlTailSource,
                                                 MicroBatchStreamingReader,
                                                 OffsetCheckpoint)
    from transmogrifai_tpu_torch.workflow.runner import RunType, WorkflowRunner

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    recs = _records(schema, 600, np.random.default_rng(11))
    model = WorkflowModel.load(FIXTURE)
    pred = model.result_features[-1].name
    card, cpu = LocalScorer(model), LocalScorer(model, device="cpu")
    assert card.device.type == "cuda"
    TKE.reset_launch_counts()
    got = card.batch(recs[:256])
    assert TKE.launch_counts()["encode_slots"] == 1
    assert TKE.launch_counts()["encode_slots.slots"] == 40
    assert got == cpu.batch(recs[:256]) and card(recs[0]) == got[0]

    events = str(tmp_path / "e.jsonl")
    with open(events, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in recs)
    reader = MicroBatchStreamingReader(
        JsonlTailSource(events), OffsetCheckpoint(str(tmp_path / "o.json")),
        batch_interval=0.0, max_batch_records=256, min_batch_records=256,
        max_empty_polls=0, sleep=lambda s: None)
    TKE.reset_launch_counts()
    res = WorkflowRunner(workflow=Workflow(), streaming_reader=reader).run(
        RunType.STREAMING_SCORE, OpParams(model_location=FIXTURE,
                                          write_location=str(tmp_path / "o" / "s.csv")))
    assert res.metrics["batches"] == 3 == TKE.launch_counts()["encode_slots"]
    with open(tmp_path / "o.json") as fh:
        assert json.load(fh)["jsonl:e.jsonl"] == os.path.getsize(events)
    want = cpu.batch(recs[256:512])
    assert [v for v in res.scores[1][pred].to_values()] == [r[pred] for r in want]


def test_continual_refit_on_the_card_builds_nothing():
    """The warm refit on the card: the prefix reused, no kernel built or
    loaded after prime, the candidate's coefficients near the CPU's."""
    import sys
    import types

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_stream_data as S

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.readers.base import rows_to_dataset
    from transmogrifai_tpu_torch.workflow import continual as C
    from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

    pkg = types.SimpleNamespace(
        FeatureBuilder=T.FeatureBuilder, transmogrify=T.transmogrify,
        BinaryClassificationModelSelector=T.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, Workflow=T.Workflow,
        rows_to_dataset=rows_to_dataset, dedup_raw_features=dedup_raw_features,
        continual=C)
    model, raws, train_ds, _ = S.continual_base(pkg, {})
    ctl = C.RefitController(model, sleep=lambda s: None)
    assert ctl.device.type == "cuda"
    ctl.prime(train_ds)
    window = rows_to_dataset(S.make_records(S.N_TRAIN, 9, shift=1.0), raws)
    res = ctl.refit(window)
    assert res.backend_compiles == 0 and res.prefix_reused and res.diagnostics == []
    cpu = C.RefitController(model, sleep=lambda s: None, device="cpu").refit(window)
    np.testing.assert_allclose(S.coefficients(res.model), S.coefficients(cpu.model),
                               rtol=0, atol=1e-5)


def test_killed_sweep_resumes_bitwise_on_the_card(tmp_path):
    """The 4-family sweep killed at the third family's device sync resumes
    with 2 journal hits, launching only the other families, bitwise equal
    to an uninterrupted run on the card."""
    from transmogrifai_tpu_torch import (BinaryClassificationModelSelector,
                                         FeatureBuilder, Workflow)
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.serve.faults import FaultHarness
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.workflow import resilience

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 16)).astype(np.float32)
    y = (rng.random(4096) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float64)

    def build():
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
        sel = BinaryClassificationModelSelector.with_cross_validation(num_folds=3, seed=7)
        pred = label.transform_with(sel, vec)
        ds = Dataset({"label": Column.from_values(RealNN, y.tolist()),
                      "features": Column.vector(x)})
        return Workflow().set_input_dataset(ds).set_result_features(label, pred), sel

    wf, ref_sel = build()
    ref = wf.train().fitted[ref_sel.uid]
    wf, _ = build()
    with FaultHarness().script("device_sync", [None, None, RuntimeError("killed")]):
        with pytest.raises(RuntimeError, match="killed"):
            wf.train(resume=str(tmp_path))
    wf, sel = build()
    TH.reset_launch_counts()
    got = wf.train(resume=str(tmp_path)).fitted[sel.uid]
    assert resilience.last().journal.hits == 2
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert [e.metric_values for e in got.summary.validation_results] == \
        [e.metric_values for e in ref.summary.validation_results]
    assert TH.launch_counts()["hist_level"] == 50 * 3 + (
        got.model.max_depth * got.model.n_trees if "GBT" in type(got.model).__name__
        else got.model.max_depth if hasattr(got.model, "trees") else 0)


def _chunked_wide(n: int):
    """The wide pipeline's vector runners, fitted on the CPU, and its raw
    table of ``n`` rows in memory and on a chunked store of 2048-row
    chunks."""
    from torch_wide_data import make_data, wide_pipeline

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.data.chunked import ChunkedDataset
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.dag import compute_dag

    cols, schema = make_data(n, n_real=6, n_bucketized=3, n_pick=4, n_levels=30,
                             n_binary=2, seed=5)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    label, _, chk, _ = wide_pipeline(T, ftypes, schema)
    vec = chk.inputs[1]
    model = T.Workflow().set_input_dataset(ds).set_result_features(vec).train(device="cpu")
    runners = [model.fitted.get(s.uid, s) for layer in compute_dag([vec]) for s in layer]
    return ds, ChunkedDataset.from_dataset(ds, chunk_rows=2048), runners, vec.name


@pytest.mark.parametrize("n", [2048 * 3, 2048 * 3 + 777])
def test_chunked_epoch_one_launch_a_chunk_one_tile_bitwise_the_cpu(n):
    """A chunked epoch on the card: one encode launch per chunk (the tail
    padded to the tile), one chunk-tile allocation, its vector bitwise the
    same epoch on the CPU and the in-memory flush."""
    from transmogrifai_tpu_torch.perf import measure_compiles
    from transmogrifai_tpu_torch.workflow.ooc import EpochStats, chunked_transform_epoch
    from transmogrifai_tpu_torch.workflow.plan import fused_transform

    ds, cds, runners, vec = _chunked_wide(n)
    TKE.reset_launch_counts()
    stats = EpochStats()
    with measure_compiles() as c:
        card = chunked_transform_epoch(cds, runners, stats=stats, device="cuda")
    counts = TKE.launch_counts()
    assert counts["encode_slots"] == stats.encode_launches == cds.n_chunks
    assert c.events.get("chunk_tile") == stats.tile_allocations == 1
    cpu = chunked_transform_epoch(cds, runners, device="cpu")
    mem = fused_transform(ds, runners, "cpu")
    got = card[vec].materialize().data
    assert got.tobytes() == cpu[vec].materialize().data.tobytes() == mem[vec].data.tobytes()


def test_chunked_epoch_kernel_error_is_not_demoted(monkeypatch):
    """A KernelError at a chunk's launch fails the epoch on the card: no
    later chunk runs and nothing reruns on the host."""
    from transmogrifai_tpu_torch.perf.kernels.dispatch import KernelError
    from transmogrifai_tpu_torch.workflow.ooc import chunked_transform_epoch

    _, cds, runners, _ = _chunked_wide(2048 * 3)
    real, calls = TKE.encode_slots, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KernelError("encode_slots: an injected launch failure")
        return real(*a, **k)

    monkeypatch.setattr(TKE, "encode_slots", failing)
    with pytest.raises(KernelError):
        chunked_transform_epoch(cds, runners, device="cuda")
    assert len(calls) == 2
