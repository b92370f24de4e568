"""tests/test_rpsan.py run on the port: all 13 cases, with imports
pointed at redpanda_tpu_torch, the subprocess cases' imports included
(they instrument the port's Consensus, GroupManager, HeartbeatManager
and FlushCoalescer). The static half still lints the fixtures with
the repo's tools/rplint. Nothing is left out.

Runtime async race sanitizer (redpanda_tpu_torch/utils/rpsan.py).

The two seeded races here are the proof pair the static rules and the
sanitizer share: each fixture is linted (RPL015 finds the shape in
source) AND executed under a forced deterministic interleaving
(rpsan catches it happening, exactly one byte-stable report). The
negative direction — RP_SAN unset means literally no descriptor on
the class — is the zero-overhead-by-construction contract.
"""

import asyncio
import os
import subprocess
import sys
import textwrap

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from redpanda_tpu_torch.utils import rpsan  # noqa: E402
from tools.rplint.engine import run_paths  # noqa: E402

# -- seeded race fixtures (linted AND executed) ------------------------

# torn read-modify-write: `+=` loads self.total BEFORE the await in
# its value expression, stores after — two tasks parked on the same
# gate both read v0, the second writer clobbers the first
COUNTER_SRC = """\
import asyncio


class Counter:
    def __init__(self, gate):
        self.gate = gate
        self.total = 0

    async def cost(self, n):
        await self.gate.wait()
        return n

    async def bump(self, n):
        self.total += await self.cost(n)
"""

# torn check-then-act: both tasks pass the None check, suspend, and
# both act — the second overwrites the first's claim
FLAG_SRC = """\
import asyncio


class Flag:
    def __init__(self, gate):
        self.gate = gate
        self.owner = None

    async def claim(self, who):
        if self.owner is None:
            await self.gate.wait()
            self.owner = who
"""

# the fix RPL015 recommends, applied: re-check after the last await
FLAG_SAFE_SRC = FLAG_SRC.replace(
    "            await self.gate.wait()\n"
    "            self.owner = who\n",
    "            await self.gate.wait()\n"
    "            if self.owner is None:\n"
    "                self.owner = who\n",
)


def _load(src: str, filename: str = "race_fixture.py") -> dict:
    ns: dict = {}
    exec(compile(src, filename, "exec"), ns)
    return ns


@pytest.fixture
def armed(monkeypatch):
    """Arm the sanitizer in-process: `instrument()` checks ENABLED at
    call time, so flipping the module flag is equivalent to RP_SAN=1
    for classes instrumented after this point."""
    monkeypatch.setattr(rpsan, "ENABLED", True)
    monkeypatch.setattr(rpsan, "INSTRUMENTED", [])
    rpsan.reset()
    yield
    rpsan.reset()


async def _race(cls, method: str, *args_per_task):
    """Run one instance's `method` from two named tasks, both parked on
    the instance's gate, then release the gate: task a resumes first
    (FIFO wakeup), task b carries the stale read."""
    gate = asyncio.Event()
    obj = cls(gate)
    tasks = [
        asyncio.ensure_future(getattr(obj, method)(a))
        for a in args_per_task
    ]
    for name, t in zip(("task-a", "task-b"), tasks):
        t.set_name(name)
    await asyncio.sleep(0)  # both tasks reach the gate
    await asyncio.sleep(0)
    gate.set()
    await asyncio.gather(*tasks)
    return obj


# -- static half of the proof pair ------------------------------------


def _lint(tmp_path, src: str):
    path = tmp_path / "race_fixture.py"
    path.write_text(textwrap.dedent(src))
    return [f for f in run_paths([str(path)]) if f.rule == "RPL015"]


def test_counter_race_found_statically(tmp_path):
    found = _lint(tmp_path, COUNTER_SRC)
    assert len(found) == 1
    assert found[0].attr == "total"
    assert "read-modify-write" in found[0].message


def test_flag_race_found_statically(tmp_path):
    found = _lint(tmp_path, FLAG_SRC)
    assert len(found) == 1
    assert found[0].attr == "owner"
    assert "check-then-act" in found[0].message


def test_recheck_fix_clean_statically(tmp_path):
    assert _lint(tmp_path, FLAG_SAFE_SRC) == []


# -- dynamic half: the same fixtures reproduce under the sanitizer ----


def test_counter_torn_rmw_exactly_one_report(armed):
    cls = rpsan.instrument(_load(COUNTER_SRC)["Counter"], ("total",))
    obj = asyncio.run(_race(cls, "bump", 1, 2))
    reps = rpsan.reports()
    assert len(reps) == 1
    r = reps[0]
    assert (r.cls, r.attr) == ("Counter", "total")
    assert r.task == "task-b"  # the stale overwriter
    assert r.writer_task == "task-a"
    assert r.read_site.startswith("race_fixture.py:")
    assert r.clobber_site.startswith("race_fixture.py:")
    # and the torn semantics actually happened: one increment lost
    assert obj.total == 2


def test_flag_torn_check_then_act_exactly_one_report(armed):
    cls = rpsan.instrument(_load(FLAG_SRC)["Flag"], ("owner",))
    obj = asyncio.run(_race(cls, "claim", "a", "b"))
    reps = rpsan.reports()
    assert len(reps) == 1
    assert (reps[0].cls, reps[0].attr) == ("Flag", "owner")
    assert obj.owner == "b"  # task-a's claim silently clobbered


def test_report_byte_stable(armed):
    """Same seeded interleaving twice → identical rendered reports:
    no ids, addresses, or clocks leak into the text."""
    cls = rpsan.instrument(_load(COUNTER_SRC)["Counter"], ("total",))
    asyncio.run(_race(cls, "bump", 1, 2))
    first = [r.render() for r in rpsan.reports()]
    rpsan.reset()
    asyncio.run(_race(cls, "bump", 1, 2))
    second = [r.render() for r in rpsan.reports()]
    assert first == second
    assert len(first) == 1
    assert "task-a" in first[0] and "task-b" in first[0]


def test_recheck_fix_clean_dynamically(armed):
    cls = rpsan.instrument(_load(FLAG_SAFE_SRC)["Flag"], ("owner",))
    obj = asyncio.run(_race(cls, "claim", "a", "b"))
    assert rpsan.reports() == []
    assert obj.owner == "a"  # first claimant wins, second re-checked


def test_blind_write_never_flags(armed):
    """A task that writes without reading since its own last write is
    last-writer-wins by declaration, not a torn read — the
    HeartbeatManager `_plan = None` invalidation shape."""
    src = """\
import asyncio


class Cache:
    def __init__(self, gate):
        self.gate = gate
        self.plan = ()

    async def invalidate(self, _):
        self.plan = ("mine",)  # own write, no read
        await self.gate.wait()
        self.plan = None  # blind reset after the suspension
"""
    cls = rpsan.instrument(_load(src)["Cache"], ("plan",))
    asyncio.run(_race(cls, "invalidate", 0, 1))
    assert rpsan.reports() == []


def test_reset_writer_allowlist(armed):
    """`reset_writers` declares a named function's writes blind resets
    (raft `_step_down` rewriting `_voted_for` under a loop-atomic term
    check): version-advancing, logged, never reported."""
    cls = rpsan.instrument(
        _load(FLAG_SRC)["Flag"], ("owner",),
        reset_writers={"owner": ("_step_down",)},
    )

    async def _step_down(obj):  # allowlisted by co_name
        obj.owner = None

    async def _foreign_write(obj):
        obj.owner = "other-task"

    async def scenario(writer):
        gate = asyncio.Event()
        obj = cls(gate)
        assert obj.owner is None  # genuine read arms this task's record
        await asyncio.ensure_future(_foreign_write(obj))  # version moves
        await writer(obj)  # same task, stale by version
        gate.set()

    # a non-allowlisted stale write reports...
    async def _unlisted(obj):
        obj.owner = None

    asyncio.run(scenario(_unlisted))
    assert len(rpsan.reports()) == 1
    rpsan.reset()

    # ...the identical write from the declared reset function does not
    asyncio.run(scenario(_step_down))
    assert rpsan.reports() == []


def test_sanitizer_off_is_structurally_absent(monkeypatch):
    """RP_SAN unset: instrument() returns the class untouched — no
    descriptor in the class dict, attribute access is a plain dict
    lookup. Zero overhead by construction, nothing to measure."""
    monkeypatch.setattr(rpsan, "ENABLED", False)
    rpsan.reset()
    ns = _load(COUNTER_SRC)
    before = dict(vars(ns["Counter"]))
    out = rpsan.instrument(ns["Counter"], ("total",))
    assert out is ns["Counter"]
    assert dict(vars(ns["Counter"])) == before
    assert "total" not in vars(ns["Counter"])
    obj = asyncio.run(_race(ns["Counter"], "bump", 1, 2))
    assert obj.total == 2  # the race happens silently — by design
    assert rpsan.reports() == []
    assert "_rpsan$total" not in obj.__dict__


def test_env_gating_subprocess():
    """The real gate is the RP_SAN env var read at import time."""
    code = (
        "from redpanda_tpu_torch.utils import rpsan;"
        "cls = rpsan.instrument(type('T', (), {}), ('x',));"
        "print(rpsan.enabled(), 'x' in vars(cls))"
    )
    for env_val, expect in (("1", "True True"), ("", "False False")):
        env = dict(os.environ, RP_SAN=env_val)
        out = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, text=True, cwd=REPO_ROOT, env=env,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == expect


def test_instrumented_production_classes_under_env(tmp_path):
    """RP_SAN=1: the four production classes register themselves at
    import, and a double instrument() is a no-op."""
    code = (
        "import redpanda_tpu_torch.raft.consensus, redpanda_tpu_torch.raft.group_manager,"
        "redpanda_tpu_torch.raft.heartbeat_manager,"
        "redpanda_tpu_torch.storage.flush_coalescer;"
        "from redpanda_tpu_torch.utils import rpsan;"
        "print(sorted(c for c, _ in rpsan.INSTRUMENTED))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO_ROOT,
        env=dict(os.environ, RP_SAN="1"),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "['Consensus', 'FlushCoalescer', 'GroupManager', 'HeartbeatManager']"
    )


def test_reports_bounded(armed):
    cls = rpsan.instrument(_load(COUNTER_SRC)["Counter"], ("total",))

    async def storm():
        gate = asyncio.Event()
        obj = cls(gate)
        gate.set()
        for _ in range(rpsan._MAX_REPORTS + 50):
            # manufacture staleness: read, advance version from "another
            # task" via direct state poke, then write
            obj.total
            state = obj.__dict__["_rpsan_state"]
            v, site = state["total"]
            state["total"] = (v + 1, site)
            obj.total = 0

    asyncio.run(storm())
    assert len(rpsan.reports()) == rpsan._MAX_REPORTS
