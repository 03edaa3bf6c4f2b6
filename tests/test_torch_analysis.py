"""The reference's lock and fault-routing lint over the port's threaded
files: ``repro.analysis.run_all(..., only={"locks", "faultok"})`` on an
``AnalysisConfig`` of ``src/repro_torch/serving/{scheduler,kv_pool,engine,
faults}.py`` and ``src/repro_torch/core/offload.py`` must find nothing.

The configuration is the reference's (``repro/analysis/config.py``) cut to
what the port carries: the same attribute types, the pool's ``on_demote``
call edge into the engine (the demotion hook runs under the pool lock), and
the engine's entry points that run off the executor thread -- service-mode
``submit`` / ``stop`` / ``load``, the captured ``failure``, and the transfer
worker's ``_spill_done`` / ``_kv_fault_hook``.  The port's sources carry
the reference's ``# guarded-by:`` / ``# assumes-lock:`` / ``# owned-by:`` /
``# fault-ok:`` annotations; the checkers hold them."""
from pathlib import Path

from repro.analysis import run_all
from repro.analysis.config import AnalysisConfig

ROOT = Path(__file__).resolve().parents[1]
SERVING = "src/repro_torch/serving"
OFFLOAD = "src/repro_torch/core/offload.py"


def port_config(root: Path = ROOT) -> AnalysisConfig:
    return AnalysisConfig(
        repo_root=root,
        lock_files=[f"{SERVING}/scheduler.py", f"{SERVING}/kv_pool.py",
                    f"{SERVING}/engine.py", OFFLOAD],
        attr_types={
            ("ContinuousScheduler", "pool"): "KVBlockPool",
            ("ServingEngine", "pool"): "KVBlockPool",
            ("ServingEngine", "scheduler"): "ContinuousScheduler",
            ("ServingEngine", "_kv_io"): "OffloadEngine",
            ("ServingEngine", "_kv_target"): "KVBlockTarget",
            ("ServingEngine", "_drafter"): "_Drafter",
            ("_Drafter", "pool"): "KVBlockPool",
            ("KVBlockPool", "host"): "HostTier",
            ("KVBlockTarget", "tier"): "HostTier",
        },
        extra_call_edges={
            # pool.on_demote is installed by the tiered engine at
            # construction; _demote_locked invokes it under the pool lock
            ("KVBlockPool", "_demote_locked"):
                [("ServingEngine", "_on_demote")],
        },
        entry_points={
            # ServingEngine state is confined to the executor thread;
            # these methods run on traffic / control / transfer threads
            "ServingEngine": {"submit", "_check_fits", "load_snapshot",
                              "load", "start", "stop", "failure",
                              "_raise_failure_once", "_spill_done",
                              "_kv_fault_hook"},
        },
        thread_files=[f"{SERVING}/engine.py", OFFLOAD],
        fault_files=[f"{SERVING}/scheduler.py", f"{SERVING}/kv_pool.py",
                     f"{SERVING}/engine.py", f"{SERVING}/faults.py",
                     OFFLOAD],
    )


def test_port_threaded_files_pass_the_lock_and_fault_lint():
    findings = run_all(port_config(), only={"locks", "faultok"})
    assert findings == [], "\n".join(map(str, findings))


def test_the_lint_sees_the_port_annotations():
    """The clean result is not an empty scan: the checkers do flag a
    guarded field read without its lock, and a swallowed exception, once
    they are put into a copy of the engine."""
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for rel in port_config().lock_files + [f"{SERVING}/faults.py"]:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(ROOT / rel, root / rel)
        eng = root / SERVING / "engine.py"
        src = eng.read_text()
        src = src.replace(
            "    def _bucket_len(self, n: int) -> int:",
            "    def _peek(self):\n"
            "        try:\n"
            "            return self._failure\n"
            "        except Exception:\n"
            "            pass\n\n"
            "    def _bucket_len(self, n: int) -> int:", 1)
        eng.write_text(src)
        rules = {f.rule for f in run_all(port_config(root),
                                         only={"locks", "faultok"})}
    assert "unguarded-field" in rules
    assert len(rules) >= 2
