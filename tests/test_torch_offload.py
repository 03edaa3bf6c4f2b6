"""The port's offload engine (``repro_torch.core.offload``), precision
estimators, Eq. 1 and image source against the reference's expectations,
on the CPU: the split-phase protocol tests of ``tests/test_offload.py`` on
the port's ``SimTarget`` / ``OffloadEngine``; ``TorchTarget`` running the
smoke GoogLeNet on an explicit ``cpu`` device; ``SyntheticImages`` bytes
equal to the JAX package's copy; the estimators and Eq. 1 as
``tests/test_precision_power.py`` pins them; and the launcher."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import precision as jprecision
from repro.data.pipeline import SyntheticImages as JaxSyntheticImages
from repro_torch.configs import registry as TR
from repro_torch.core.offload import (OffloadEngine, SimTarget, TorchTarget,
                                      WorkError)
from repro_torch.core.power import (PAPER_TDP_W, joules_per_item, report,
                                    throughput_per_watt)
from repro_torch.core.precision import (BF16, FP16, FP32, POLICIES,
                                        confidence_delta, prediction_agreement,
                                        top1_delta, top1_error_rate)
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.kernels import dispatch
from repro_torch.launch import offload_inference
from repro_torch.models import googlenet

torch.set_num_threads(1)


# --- split-phase protocol (mirrors tests/test_offload.py) ------------------

def test_results_in_queueing_order():
    targets = [SimTarget(f"t{i}", compute_s=0.001 * (i + 1)) for i in range(3)]
    with OffloadEngine(targets) as eng:
        results, stats = eng.run(list(range(20)))
    assert results == list(range(20))       # paper Fig 4: collect in order
    assert stats.items == 20


def test_exit_closes_every_target_before_raising():
    closed = []

    class Flaky(SimTarget):
        def __init__(self, name, fail):
            super().__init__(name, compute_s=0.001)
            self.fail = fail

        def close(self):
            closed.append(self.name)
            super().close()
            if self.fail:
                raise RuntimeError(f"{self.name} wedged")

    targets = [Flaky("t0", fail=True), Flaky("t1", fail=False)]
    with pytest.raises(RuntimeError, match="t0 wedged"):
        with OffloadEngine(targets) as eng:
            eng.run([1, 2])
    assert closed == ["t0", "t1"]


def test_round_robin_assignment():
    targets = [SimTarget(f"t{i}", compute_s=0.001) for i in range(4)]
    with OffloadEngine(targets, scheduler="round_robin") as eng:
        _, stats = eng.run(list(range(16)))
    assert all(v == 4 for v in stats.per_target.values())


def test_least_loaded_prefers_fast_target():
    targets = [SimTarget("slow", compute_s=0.05),
               SimTarget("fast", compute_s=0.002)]
    with OffloadEngine(targets, scheduler="least_loaded") as eng:
        _, stats = eng.run(list(range(24)))
    assert stats.per_target.get("fast", 0) > stats.per_target.get("slow", 0)


def test_callable_placement_hook():
    targets = [SimTarget("even", compute_s=0.002),
               SimTarget("odd", compute_s=0.002)]
    with OffloadEngine(targets,
                       scheduler=lambda ts, payload: ts[payload % 2]) as eng:
        results, stats = eng.run_unordered(list(range(10)))
    assert sorted(seq for seq, _ in results) == list(range(10))
    assert stats.per_target == {"even": 5, "odd": 5}


def test_split_phase_overlap():
    t = SimTarget("t", compute_s=0.2)
    with OffloadEngine([t]) as eng:
        t0 = time.monotonic()
        item = eng.submit("x")
        assert time.monotonic() - t0 < 0.05          # mvncLoadTensor semantics
        assert eng.get_result(item) == "x"


def test_straggler_reissue_fast_target_wins():
    targets = [SimTarget("stuck", compute_s=0.5,
                         result_fn=lambda p: ("stuck", p)),
               SimTarget("fast", compute_s=0.005,
                         result_fn=lambda p: ("fast", p))]
    with OffloadEngine(targets, deadline_s=0.05) as eng:
        results, stats = eng.run(list(range(6)))
    assert results == [("fast", p) for p in range(6)]
    assert stats.per_target.get("fast", 0) == 6
    assert stats.reissues >= 3


def test_out_of_order_drain_no_head_of_line():
    targets = [SimTarget("slow", compute_s=0.3),
               SimTarget("fast", compute_s=0.005)]
    with OffloadEngine(targets) as eng:       # round robin: even seqs slow
        for p in range(4):
            eng.submit_async(p)
        seqs = [item.seq for item in eng.drain(4)]
    assert sorted(seqs) == [0, 1, 2, 3]
    assert seqs[0] in (1, 3)


def test_run_unordered_results_and_window():
    targets = [SimTarget(f"t{i}", compute_s=0.003) for i in range(3)]
    with OffloadEngine(targets) as eng:
        results, stats = eng.run_unordered(list(range(20)), window=4)
    assert sorted(seq for seq, _ in results) == list(range(20))
    assert all(seq == res for seq, res in results)
    assert stats.items == 20


def test_async_on_done_callback_fires_once():
    fired = []
    ev = threading.Event()
    t = SimTarget("t", compute_s=0.01)
    with OffloadEngine([t]) as eng:
        eng.submit("x", on_done=lambda it: (fired.append(it.result), ev.set()))
        assert ev.wait(5)
    assert fired == ["x"]


def test_multi_device_scaling():
    # items of 40 ms compute and 10 ms transfer: a thread's wake-up late by a
    # few ms under a loaded host (six test workers) is a few per cent of an
    # item, where at 4 + 1 ms it took the 4-target ratio from ~4 to 2.42
    def mk(n):
        return [SimTarget(f"v{i}", compute_s=0.04, transfer_s=0.01)
                for i in range(n)]
    with OffloadEngine(mk(1)) as eng:
        _, s1 = eng.run(list(range(30)))
    with OffloadEngine(mk(4)) as eng:
        _, s4 = eng.run(list(range(30)))
    assert s4.throughput / s1.throughput > 2.5


def test_raising_execute_commits_a_work_error():
    def boom(_):
        raise ValueError("bad payload")
    t = SimTarget("t", compute_s=0.0, result_fn=boom)
    with OffloadEngine([t]) as eng:
        results, _ = eng.run([1])
    assert isinstance(results[0], WorkError)
    assert isinstance(results[0].error, ValueError)


# --- TorchTarget ------------------------------------------------------------

def test_torch_target_runs_smoke_googlenet_on_cpu():
    """Payloads go to the device as tensors, results come back as numpy
    (bf16 as float32); the forward runs the conv kernel's plain version."""
    cfg = TR.smoke("googlenet")
    params = googlenet.init(cfg, torch.Generator().manual_seed(0))
    target = TorchTarget(
        lambda im: {"labels": googlenet.predict(cfg, params, im)[0],
                    "half": im[:1, :1, :1].bfloat16()},
        name="cpu", device="cpu")
    images = SyntheticImages(batch=2, size=64, seed=1).sample(2)["images"]
    dispatch.reset_counts()
    with OffloadEngine([target]) as eng:
        results, stats = eng.run([images, images[::-1].copy()])
    assert stats.items == 2 and stats.per_target == {"cpu": 2}
    a, b = results
    assert isinstance(a["labels"], np.ndarray) and a["labels"].shape == (2,)
    assert (a["labels"] == b["labels"][::-1]).all()
    assert a["half"].dtype == np.float32
    k = dispatch.kernel_table()["conv2d"]
    assert (k.launches, k.plain_calls) == (0, 2 * 57)
    with torch.no_grad():
        ref = googlenet.predict(cfg, params, torch.from_numpy(images))[0]
    assert (a["labels"] == ref.numpy()).all()


def test_torch_target_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTarget(lambda x: x, device="cuda")


# --- data, precision, power -------------------------------------------------

@pytest.mark.parametrize("seed,size,n", [(0, 224, 2), (7, 64, 5)])
def test_synthetic_images_equal_the_jax_copy(seed, size, n):
    ours = SyntheticImages(batch=n, size=size, seed=seed)
    ref = JaxSyntheticImages(batch=n, size=size, seed=seed)
    for _ in range(2):
        a, b = next(ours), next(ref)
        assert a["images"].tobytes() == b["images"].tobytes()
        assert a["labels"].tobytes() == b["labels"].tobytes()


def _probs(pred, conf, n_classes=10):
    out = np.full((len(pred), n_classes), (1 - np.array(conf))[:, None]
                  / (n_classes - 1))
    out[np.arange(len(pred)), pred] = conf
    return out


def test_precision_estimators_match_the_reference():
    labels = np.array([1, 2, 3])
    p = _probs([1, 2, 3], [0.9, 0.8, 0.7])
    assert top1_delta(p, p, labels) == 0.0
    assert confidence_delta(p, p, labels) == 0.0
    assert prediction_agreement(p, p) == 1.0
    assert top1_error_rate(_probs([1, 2, 0], [0.9] * 3), labels) == pytest.approx(1 / 3)
    pa = _probs([1, 2, 0], [0.9, 0.8, 0.9])
    pb = _probs([1, 2, 3], [0.8, 0.7, 0.9])
    assert confidence_delta(pa, pb, labels) == pytest.approx(0.1)
    rng = np.random.default_rng(0)
    qa = rng.dirichlet(np.ones(10), 32)
    qb = 0.8 * qa + 0.2 * rng.dirichlet(np.ones(10), 32)
    lab = qa.argmax(-1)
    lab[::4] = 0
    for name in ("top1_delta", "confidence_delta"):
        ref = getattr(jprecision, name)(qa, qb, lab)
        assert np.isfinite(ref) and ref == globals()[name](qa, qb, lab)
    assert jprecision.prediction_agreement(qa, qb) == prediction_agreement(qa, qb)
    for ours in (FP32, BF16, FP16):
        ref = jprecision.POLICIES[ours.name]
        assert (ours.param_dtype, ours.compute_dtype, ours.cache_dtype) == \
            (ref.param_dtype, ref.compute_dtype, ref.cache_dtype)
    assert set(POLICIES) == set(jprecision.POLICIES)
    cast = FP16.cast_params({"w": torch.ones(2), "n": torch.ones(2, dtype=torch.int32)})
    assert cast["w"].dtype == torch.float16 and cast["n"].dtype == torch.int32


def test_power_eq1_paper_numbers():
    assert throughput_per_watt(77.2, 8 * 2.5) == pytest.approx(3.86, abs=0.1)
    r = report("vpu", 8, 77.2, per_device_watts=2.5)
    assert r.items_per_watt == pytest.approx(3.86, abs=0.1)
    assert joules_per_item(77.2, 20.0) == pytest.approx(0.259, abs=1e-2)
    assert report("vpu", 2, 10.0).tdp_watts_total == 2 * PAPER_TDP_W["vpu"]
    card = report("NVIDIA H100 80GB HBM3", 1, 700.0, per_device_watts=700.0)
    assert card.items_per_watt == 1.0
    with pytest.raises(ValueError, match="per_device_watts"):
        report("h100", 1, 100.0)                 # no TDP falls back


# --- launcher -----------------------------------------------------------------

def test_launcher_runs_on_the_cpu(capsys):
    assert offload_inference.main(["--device", "cpu", "--size", "64",
                                   "--batches", "2"]) == 0
    out = capsys.readouterr().out
    assert "conv2d launches 0 (0 per forward), plain calls 114" in out
    assert "[fig7] fp16 vs fp32 over 48 images" in out
    assert "[vpu x8]" in out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(SystemExit):
        offload_inference.main(["--size", "64", "--batches", "1"])
