"""Concrete tunables (reference: src/go/rpk/pkg/tuners/).

Each reports current-vs-desired through SysFs; apply is opt-in
(dry-run default). Coverage mirrors the reference's checker inventory:
cpu governor (tuners/cpu/tuner.go), irqbalance + IRQ affinity
(tuners/irq/), NIC queue spread (tuners/ethtool, network tuner),
fstrim (tuners/fstrim.go), swappiness / aio-max-nr (tuners/sys*),
clocksource (tuners/clocksource.go), transparent hugepages, ballast
file (tuners/ballast/), iotune properties (tuners/iotune.go)."""

from __future__ import annotations

import os

from .framework import Severity, TuneAction, Tuner

_CPU_GLOB = "/sys/devices/system/cpu/cpu*/cpufreq/scaling_governor"


class CpuGovernorTuner(Tuner):
    """All cores pinned to the `performance` governor
    (ref tuners/cpu/tuner.go)."""

    name = "cpu_governor"
    desc = "CPU frequency governor is 'performance' on every core"
    severity = Severity.WARNING

    def _paths(self) -> list[str]:
        return self.fs.glob(_CPU_GLOB)

    def supported(self) -> bool:
        return bool(self._paths())

    def current(self) -> str:
        govs = {self.fs.read(p) for p in self._paths()}
        govs.discard(None)
        return ",".join(sorted(govs)) if govs else "unknown"

    def required(self) -> str:
        return "performance"

    def plan(self) -> list[TuneAction]:
        return [
            TuneAction("write", p, "performance")
            for p in self._paths()
            if self.fs.read(p) != "performance"
        ]


class IrqBalanceTuner(Tuner):
    """irqbalance must not rebalance redpanda's IRQs — the reference
    masks banned CPUs via IRQBALANCE_BANNED_CPUS
    (ref tuners/irq/balance_service.go)."""

    name = "irq_balance"
    desc = "irqbalance disabled or configured with banned CPUs"
    severity = Severity.WARNING

    CONF = "/etc/default/irqbalance"
    PROC = "/proc/irq"

    def supported(self) -> bool:
        return self.fs.exists(self.PROC)

    def _running(self) -> bool:
        # pid files / systemd state are distro-specific; the portable
        # signal is the config file's enable flag when present
        conf = self.fs.read(self.CONF)
        if conf is None:
            return False  # not installed → nothing rebalances IRQs
        for line in conf.splitlines():
            line = line.strip()
            if line.startswith("ENABLED="):
                return line.split("=", 1)[1].strip('"') != "0"
        return True

    def current(self) -> str:
        return "running" if self._running() else "disabled"

    def required(self) -> str:
        return "disabled"

    def plan(self) -> list[TuneAction]:
        conf = self.fs.read(self.CONF) or ""
        lines = [
            l for l in conf.splitlines() if not l.startswith("ENABLED=")
        ]
        lines.append('ENABLED="0"')
        return [TuneAction("write", self.CONF, "\n".join(lines) + "\n")]


class IrqAffinityTuner(Tuner):
    """Storage/NIC IRQs spread across cores instead of piling on
    cpu0 (ref tuners/irq/cpu_masks.go). Check: no single CPU owns
    more than half the active IRQs."""

    name = "irq_affinity"
    desc = "hardware IRQs spread across CPUs"
    severity = Severity.WARNING

    def supported(self) -> bool:
        return bool(self.fs.listdir("/proc/irq"))

    def _masks(self) -> dict[str, str]:
        out = {}
        for irq in self.fs.listdir("/proc/irq"):
            if not irq.isdigit():
                continue
            m = self.fs.read(f"/proc/irq/{irq}/smp_affinity")
            if m is not None:
                out[irq] = m
        return out

    def current(self) -> str:
        masks = self._masks()
        if not masks:
            return "none"
        from collections import Counter

        c = Counter(masks.values())
        top_mask, top_n = c.most_common(1)[0]
        return f"{len(masks)} irqs, {top_n} share mask {top_mask}"

    def required(self) -> str:
        return "no mask owns a majority of irqs"

    def ok(self) -> bool:
        masks = self._masks()
        if len(masks) <= 1 or self.fs.cpu_count() == 1:
            return True
        from collections import Counter

        _, top_n = Counter(masks.values()).most_common(1)[0]
        return top_n <= len(masks) // 2 + (len(masks) % 2)

    def plan(self) -> list[TuneAction]:
        masks = self._masks()
        ncpu = self.fs.cpu_count()
        actions = []
        for i, irq in enumerate(sorted(masks, key=int)):
            want = format(1 << (i % ncpu), "x")
            if masks[irq].lstrip("0") != want:
                actions.append(
                    TuneAction(
                        "write", f"/proc/irq/{irq}/smp_affinity", want
                    )
                )
        return actions


class NicQueuesTuner(Tuner):
    """RPS spread: each NIC rx queue's rps_cpus covers all cores
    (ref tuners/network.go + irq/device_info.go)."""

    name = "nic_queues"
    desc = "NIC RPS queues fan out to all CPUs"
    severity = Severity.WARNING

    SYS = "/sys/class/net"

    def _queues(self) -> list[str]:
        out = []
        for dev in self.fs.listdir(self.SYS):
            if dev == "lo":
                continue
            for q in self.fs.listdir(f"{self.SYS}/{dev}/queues"):
                if q.startswith("rx-"):
                    out.append(f"{self.SYS}/{dev}/queues/{q}/rps_cpus")
        return out

    def supported(self) -> bool:
        return bool(self._queues())

    def _full_mask(self) -> str:
        return format((1 << self.fs.cpu_count()) - 1, "x")

    def current(self) -> str:
        vals = {self.fs.read(q) or "0" for q in self._queues()}
        return ",".join(sorted(v.lstrip("0") or "0" for v in vals))

    def required(self) -> str:
        return self._full_mask()

    def ok(self) -> bool:
        if self.fs.cpu_count() == 1:
            return True
        want = self._full_mask()
        return all(
            (self.fs.read(q) or "0").lstrip("0") == want
            for q in self._queues()
        )

    def plan(self) -> list[TuneAction]:
        want = self._full_mask()
        return [
            TuneAction("write", q, want)
            for q in self._queues()
            if (self.fs.read(q) or "0").lstrip("0") != want
        ]


class FstrimTuner(Tuner):
    """Periodic fstrim keeps SSD write latency stable
    (ref tuners/fstrim.go enables the systemd timer)."""

    name = "fstrim"
    desc = "fstrim.timer enabled (periodic SSD TRIM)"
    severity = Severity.WARNING

    WANTS = "/etc/systemd/system/timers.target.wants/fstrim.timer"
    UNIT_DIRS = (
        "/usr/lib/systemd/system/fstrim.timer",
        "/lib/systemd/system/fstrim.timer",
    )

    def supported(self) -> bool:
        return any(self.fs.exists(p) for p in self.UNIT_DIRS)

    def current(self) -> str:
        return "enabled" if self.fs.exists(self.WANTS) else "disabled"

    def required(self) -> str:
        return "enabled"

    def plan(self) -> list[TuneAction]:
        unit = next(
            (p for p in self.UNIT_DIRS if self.fs.exists(p)),
            self.UNIT_DIRS[0],
        )
        # symlink via write-through (SysFs has no symlink op; systemd
        # accepts a copied unit in the wants dir)
        return [TuneAction("cmd", f"systemctl enable fstrim.timer ({unit})")]


class SwappinessTuner(Tuner):
    """vm.swappiness=1: never swap the broker under memory pressure
    (ref tuners/sys/ and the rpk production checklist)."""

    name = "swappiness"
    desc = "vm.swappiness == 1"
    severity = Severity.WARNING

    PATH = "/proc/sys/vm/swappiness"

    def supported(self) -> bool:
        return self.fs.read(self.PATH) is not None

    def current(self) -> str:
        return self.fs.read(self.PATH) or "?"

    def required(self) -> str:
        return "1"

    def plan(self) -> list[TuneAction]:
        return [TuneAction("write", self.PATH, "1")]


class AioMaxTuner(Tuner):
    """fs.aio-max-nr >= 1048576 (ref tuners/aio.go — seastar needs
    deep aio queues; our io layer sizes against the same limit)."""

    name = "aio_max_nr"
    desc = "fs.aio-max-nr >= 1048576"
    severity = Severity.FATAL

    PATH = "/proc/sys/fs/aio-max-nr"
    WANT = 1048576

    def supported(self) -> bool:
        return self.fs.read(self.PATH) is not None

    def current(self) -> str:
        return self.fs.read(self.PATH) or "?"

    def required(self) -> str:
        return f">={self.WANT}"

    def ok(self) -> bool:
        cur = self.fs.read(self.PATH)
        return cur is not None and int(cur) >= self.WANT

    def plan(self) -> list[TuneAction]:
        return [TuneAction("write", self.PATH, str(self.WANT))]


class ClocksourceTuner(Tuner):
    """tsc clocksource: hpet/acpi_pm cost microseconds per read and
    the broker timestamps every batch (ref tuners/clocksource.go)."""

    name = "clocksource"
    desc = "current clocksource is tsc (x86) or arch native"
    severity = Severity.WARNING

    CUR = "/sys/devices/system/clocksource/clocksource0/current_clocksource"
    AVAIL = (
        "/sys/devices/system/clocksource/clocksource0/available_clocksource"
    )

    def supported(self) -> bool:
        return self.fs.read(self.CUR) is not None

    def current(self) -> str:
        return self.fs.read(self.CUR) or "?"

    def required(self) -> str:
        avail = (self.fs.read(self.AVAIL) or "").split()
        return "tsc" if "tsc" in avail else (self.current() or "tsc")

    def plan(self) -> list[TuneAction]:
        return [TuneAction("write", self.CUR, self.required())]


class TransparentHugepagesTuner(Tuner):
    """THP 'always' causes latency spikes from khugepaged compaction;
    'madvise' lets the allocator opt in (production checklist)."""

    name = "transparent_hugepages"
    desc = "THP set to madvise (or never)"
    severity = Severity.WARNING

    PATH = "/sys/kernel/mm/transparent_hugepage/enabled"

    def supported(self) -> bool:
        return self.fs.read(self.PATH) is not None

    def current(self) -> str:
        raw = self.fs.read(self.PATH) or ""
        for tok in raw.split():
            if tok.startswith("["):
                return tok.strip("[]")
        return raw

    def required(self) -> str:
        return "madvise"

    def ok(self) -> bool:
        return self.current() in ("madvise", "never")

    def plan(self) -> list[TuneAction]:
        return [TuneAction("write", self.PATH, "madvise")]


class BallastTuner(Tuner):
    """Ballast file reserves emergency disk headroom
    (ref tuners/ballast/ — deleting it buys recovery room on ENOSPC)."""

    name = "ballast_file"
    desc = "ballast file present in the data directory"
    severity = Severity.WARNING
    SIZE = 1 << 30

    def __init__(self, fs=None, data_dir: str = "/var/lib/redpanda/data"):
        super().__init__(fs)
        self.path = os.path.join(data_dir, "ballast")

    def current(self) -> str:
        return "present" if self.fs.exists(self.path) else "absent"

    def required(self) -> str:
        return "present"

    def plan(self) -> list[TuneAction]:
        return [TuneAction("write", self.path, "\0" * 4096)]


class IoTuneTuner(Tuner):
    """Measured io properties file exists (ref tuners/iotune.go runs
    iotune to fingerprint the disk; the runtime reads the result to
    size its io scheduler). Detection only: measurement needs a long
    privileged disk run."""

    name = "io_properties"
    desc = "io-config.yaml with measured disk properties exists"
    severity = Severity.WARNING

    def __init__(self, fs=None, conf_dir: str = "/etc/redpanda"):
        super().__init__(fs)
        self.path = os.path.join(conf_dir, "io-config.yaml")

    def current(self) -> str:
        return "present" if self.fs.exists(self.path) else "absent"

    def required(self) -> str:
        return "present"

    def plan(self) -> list[TuneAction]:
        return [
            TuneAction(
                "cmd",
                "rpk iotune  # long-running disk fingerprint, run once",
            )
        ]


TUNERS = [
    CpuGovernorTuner,
    IrqBalanceTuner,
    IrqAffinityTuner,
    NicQueuesTuner,
    FstrimTuner,
    SwappinessTuner,
    AioMaxTuner,
    ClocksourceTuner,
    TransparentHugepagesTuner,
    BallastTuner,
    IoTuneTuner,
]
