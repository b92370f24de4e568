"""tests/test_tuners.py run on the port: all 12 test functions, with
imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


rpk tuner framework: detection, dry-run plans, apply-through-fs.

Reference behavior being mirrored: src/go/rpk/pkg/tuners/check.go Check
runs every checker and reports current-vs-required without mutating;
tune applies through the fs layer (tests use in-memory fs, afero
analog)."""

import pytest

from redpanda_tpu_torch.tuners import (
    FakeSysFs,
    Severity,
    check_all,
    tune_all,
)
from redpanda_tpu_torch.tuners.tunables import (
    AioMaxTuner,
    BallastTuner,
    ClocksourceTuner,
    CpuGovernorTuner,
    FstrimTuner,
    IoTuneTuner,
    IrqAffinityTuner,
    IrqBalanceTuner,
    NicQueuesTuner,
    SwappinessTuner,
    TransparentHugepagesTuner,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

GOV0 = "/sys/devices/system/cpu/cpu0/cpufreq/scaling_governor"
GOV1 = "/sys/devices/system/cpu/cpu1/cpufreq/scaling_governor"


def test_cpu_governor_detects_and_plans():
    fs = FakeSysFs({GOV0: "powersave", GOV1: "performance"})
    t = CpuGovernorTuner(fs)
    r = t.check()
    assert r.supported and not r.ok
    assert "powersave" in r.current
    plan = t.tune()  # dry-run default
    assert plan.changed
    assert plan.actions == [
        a for a in plan.actions if a.target == GOV0
    ], "only the non-compliant core is rewritten"
    assert not plan.applied
    assert fs.writes == [], "dry-run must not write"


def test_cpu_governor_apply_writes_through_fs():
    fs = FakeSysFs({GOV0: "powersave"})
    t = CpuGovernorTuner(fs)
    res = t.tune(dry_run=False)
    assert res.applied
    assert fs.writes == [(GOV0, "performance")]
    assert t.check().ok


def test_cpu_governor_unsupported_without_cpufreq():
    fs = FakeSysFs({})
    r = CpuGovernorTuner(fs).check()
    assert r.ok and not r.supported


def test_irqbalance_detection():
    fs = FakeSysFs(
        {
            "/proc/irq/10/smp_affinity": "1",
            "/etc/default/irqbalance": 'ENABLED="1"\nOPTIONS=""\n',
        }
    )
    t = IrqBalanceTuner(fs)
    assert t.check().current == "running"
    res = t.tune(dry_run=False)
    assert res.applied
    assert IrqBalanceTuner(fs).check().ok
    # not installed → already ok
    fs2 = FakeSysFs({"/proc/irq/10/smp_affinity": "1"})
    assert IrqBalanceTuner(fs2).check().ok


def test_irq_affinity_spread():
    files = {f"/proc/irq/{i}/smp_affinity": "1" for i in range(10, 16)}
    fs = FakeSysFs(files)
    fs.ncpu = 4
    t = IrqAffinityTuner(fs)
    r = t.check()
    assert not r.ok, "all irqs on cpu0 must fail the spread check"
    plan = t.tune()
    assert plan.changed and len(plan.actions) >= 4
    # single-core boxes cannot spread: vacuously ok
    fs.ncpu = 1
    assert IrqAffinityTuner(fs).check().ok


def test_nic_queue_rps():
    q = "/sys/class/net/eth0/queues/rx-0/rps_cpus"
    fs = FakeSysFs({q: "0"})
    fs.ncpu = 4
    t = NicQueuesTuner(fs)
    assert not t.check().ok
    res = t.tune(dry_run=False)
    assert res.applied and fs.files[q] == "f"
    assert NicQueuesTuner(fs).check().ok


def test_fstrim_detection_plan_is_command():
    fs = FakeSysFs({"/usr/lib/systemd/system/fstrim.timer": "[Timer]"})
    t = FstrimTuner(fs)
    assert not t.check().ok
    plan = t.tune()
    assert plan.actions[0].kind == "cmd"
    # cmd actions refuse silent apply
    res = t.tune(dry_run=False)
    assert not res.applied and res.error


def test_swappiness_and_aio_and_thp():
    fs = FakeSysFs(
        {
            "/proc/sys/vm/swappiness": "60",
            "/proc/sys/fs/aio-max-nr": "65536",
            "/sys/kernel/mm/transparent_hugepage/enabled":
                "[always] madvise never",
        }
    )
    sw = SwappinessTuner(fs)
    assert not sw.check().ok
    sw.tune(dry_run=False)
    assert fs.files["/proc/sys/vm/swappiness"] == "1"

    aio = AioMaxTuner(fs)
    r = aio.check()
    assert not r.ok and r.severity is Severity.FATAL
    aio.tune(dry_run=False)
    assert AioMaxTuner(fs).check().ok
    # larger-than-minimum also ok
    fs.files["/proc/sys/fs/aio-max-nr"] = "2097152"
    assert AioMaxTuner(fs).check().ok

    thp = TransparentHugepagesTuner(fs)
    assert thp.check().current == "always"
    assert not thp.check().ok
    fs.files["/sys/kernel/mm/transparent_hugepage/enabled"] = (
        "always [madvise] never"
    )
    assert TransparentHugepagesTuner(fs).check().ok


def test_clocksource_prefers_tsc_when_available():
    cur = "/sys/devices/system/clocksource/clocksource0/current_clocksource"
    avail = (
        "/sys/devices/system/clocksource/clocksource0/available_clocksource"
    )
    fs = FakeSysFs({cur: "hpet", avail: "tsc hpet acpi_pm"})
    t = ClocksourceTuner(fs)
    assert not t.check().ok
    t.tune(dry_run=False)
    assert fs.files[cur] == "tsc"
    # no tsc available (arm): current is accepted
    fs2 = FakeSysFs({cur: "arch_sys_counter", avail: "arch_sys_counter"})
    assert ClocksourceTuner(fs2).check().ok


def test_ballast_and_iotune_detection():
    fs = FakeSysFs({})
    b = BallastTuner(fs, data_dir="/data")
    assert b.check().current == "absent"
    b.tune(dry_run=False)
    assert b.check().current == "present"
    io = IoTuneTuner(fs, conf_dir="/etc/redpanda")
    assert io.check().current == "absent"
    assert io.tune().actions[0].kind == "cmd"


def test_check_all_never_crashes_and_reports_each_tuner():
    fs = FakeSysFs({})  # empty host: everything unsupported or absent
    results = check_all(fs)
    assert len(results) == 11
    assert all(r.error is None for r in results)
    plans = tune_all(fs)
    assert all(p.error is None or p.actions for p in plans)


def test_cli_check_runs_on_real_host(capsys):
    """The real-SysFs path must run unprivileged without crashing."""
    from redpanda_tpu_torch.tuners import check_all as real_check

    results = real_check()
    assert len(results) == 11
    for r in results:
        assert isinstance(r.current, str)
