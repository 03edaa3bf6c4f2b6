"""The reference's lock and fault-routing lint over the port's threaded
files: ``repro.analysis.run_all(..., only={"locks", "faultok"})`` on an
``AnalysisConfig`` of ``src/repro_torch/serving/{scheduler,kv_pool,engine,
router,faults}.py``, ``src/repro_torch/core/offload.py`` and the kernel
table's launch counters (``src/repro_torch/kernels/dispatch.py``, bumped
from every executor thread of a fleet) must find nothing.

The configuration is the reference's (``repro/analysis/config.py``) cut to
what the port carries: the same attribute types, the pool's ``on_demote``
call edge into the engine (the demotion hook runs under the pool lock), the
migration path's edges (a prefill replica's ``_handoff`` calls the router's
``_migrate``; the migration worker's ``KVBlockTarget.execute`` calls
``_MigrationAdapter.adopt``, which calls the decode replica's
``adopt_blocks``), the engine's entry points that run off the executor
thread -- service-mode ``submit`` / ``stop`` / ``load``, the captured
``failure``, the transfer worker's ``_spill_done`` / ``_kv_fault_hook``,
the migration worker's ``adopt_blocks`` -- and the router's that run off
the dispatch thread (rebalance, failure routing, migration).  The port's sources carry
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
                    f"{SERVING}/engine.py", f"{SERVING}/router.py", OFFLOAD,
                    "src/repro_torch/kernels/dispatch.py"],
        attr_types={
            ("ContinuousScheduler", "pool"): "KVBlockPool",
            ("ServingEngine", "pool"): "KVBlockPool",
            ("ServingEngine", "scheduler"): "ContinuousScheduler",
            ("ServingEngine", "_kv_io"): "OffloadEngine",
            ("ServingEngine", "_kv_target"): "KVBlockTarget",
            ("ServingEngine", "_drafter"): "_Drafter",
            ("_Drafter", "pool"): "KVBlockPool",
            ("KVBlockPool", "host"): "HostTier",
            ("ReplicaTarget", "engine"): "ServingEngine",
            ("KVBlockTarget", "tier"): "HostTier",
            ("_MigrationAdapter", "engine"): "ServingEngine",
            ("_MigrationAdapter", "router"): "ReplicaRouter",
        },
        extra_call_edges={
            # pool.on_demote is installed by the tiered engine at
            # construction; _demote_locked invokes it under the pool lock
            ("KVBlockPool", "_demote_locked"):
                [("ServingEngine", "_on_demote")],
            # the router installs _on_prefilled on prefill-role engines, so
            # prefill completion calls back into the router, which submits
            # a migrate payload whose KVBlockTarget "tier" is a
            # _MigrationAdapter that lands the blocks via adopt_blocks
            ("ServingEngine", "_handoff"):
                [("ReplicaRouter", "_migrate")],
            ("KVBlockTarget", "execute"):
                [("_MigrationAdapter", "adopt")],
            ("_MigrationAdapter", "adopt"):
                [("ServingEngine", "adopt_blocks")],
        },
        entry_points={
            # ServingEngine state is confined to the executor thread;
            # these methods run on traffic / control / transfer threads
            "ServingEngine": {"submit", "_check_fits", "load_snapshot",
                              "load", "start", "stop", "failure",
                              "_raise_failure_once", "_spill_done",
                              "_kv_fault_hook", "adopt_blocks"},
            # the rebalance loop runs on the steal thread, failure routing
            # on whichever replica thread terminated the request, and the
            # migration path on source executor threads (_migrate) and the
            # migration worker (_mig_done, _place_migration);
            # dispatch-thread state (the fleet prefix index) must stay off
            # all of them
            "ReplicaRouter": {"_rebalance_once", "_steal_loop",
                              "_heartbeat", "_on_request_failed",
                              "_migrate", "_select_decode", "_mig_done",
                              "_place_migration", "drain_migrations"},
        },
        thread_files=[f"{SERVING}/engine.py", f"{SERVING}/router.py",
                      OFFLOAD],
        fault_files=[f"{SERVING}/scheduler.py", f"{SERVING}/kv_pool.py",
                     f"{SERVING}/engine.py", f"{SERVING}/router.py",
                     f"{SERVING}/faults.py", OFFLOAD],
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
