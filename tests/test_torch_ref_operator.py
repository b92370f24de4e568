"""tests/test_operator.py run on the port: all 12 test functions, with
imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Cluster CRD reconcile-controller tests (reference: src/go/k8s
operator behavior — create/adopt, idempotency, scale-up, and the
decommission-before-shrink ordering on scale-down)."""

import asyncio

import pytest

from redpanda_tpu_torch.operator import (
    CRD_PLURAL,
    GROUP,
    VERSION,
    ClusterSpec,
    FakeKubeApi,
    KubeError,
    Operator,
    Reconciler,
    desired_statefulset,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

CR_API = f"{GROUP}/{VERSION}"


def _cr(name="rp", replicas=3, **spec):
    return {
        "apiVersion": CR_API,
        "kind": "Cluster",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"replicas": replicas, **spec},
    }


def _run(coro):
    return asyncio.run(coro)


def test_create_from_empty():
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr(replicas=3, image="img:1"))
    _run(Reconciler(api).reconcile(cr))

    sts = api.objects[("apps/v1", "default", "statefulsets", "rp")]
    svc = api.objects[("v1", "default", "services", "rp")]
    assert sts["spec"]["replicas"] == 3
    assert sts["spec"]["template"]["spec"]["containers"][0]["image"] == "img:1"
    assert svc["spec"]["clusterIP"] == "None"
    # seeds cover every ordinal through the headless service
    args = sts["spec"]["template"]["spec"]["containers"][0]["args"]
    seeds = next(a for a in args if a.startswith("--seeds="))
    assert seeds.count("rp-") == 3 and "rp-2.rp.default.svc" in seeds
    # status written back
    status = api.objects[(CR_API, "default", CRD_PLURAL, "rp")]["status"]
    assert status["replicas"] == 3
    assert status["conditions"][0]["type"] == "Reconciled"


def test_reconcile_idempotent():
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr())
    _run(Reconciler(api).reconcile(cr))
    writes_after_first = [w for w in api.writes if w[0] != "status"]
    _run(Reconciler(api).reconcile(cr))
    # second pass: no create/replace, only a status write
    assert [w for w in api.writes if w[0] != "status"] == writes_after_first


def test_scale_up_patches_immediately():
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr(replicas=3))
    decommissions = []

    async def decom(spec, ordinal):
        decommissions.append(ordinal)

    r = Reconciler(api, decommission=decom)
    _run(r.reconcile(cr))
    cr["spec"]["replicas"] = 5
    api.seed(CR_API, CRD_PLURAL, cr)  # user edits the CR
    _run(r.reconcile(cr))
    sts = api.objects[("apps/v1", "default", "statefulsets", "rp")]
    assert sts["spec"]["replicas"] == 5
    assert decommissions == []  # scale-up never decommissions


def test_scale_down_decommissions_highest_first():
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr(replicas=5))
    order = []

    async def decom(spec, ordinal):
        # statefulset must still be at the OLD size while draining
        sts = api.objects[("apps/v1", "default", "statefulsets", spec.name)]
        assert sts["spec"]["replicas"] == 5
        order.append(ordinal)

    r = Reconciler(api, decommission=decom)
    _run(r.reconcile(cr))
    cr["spec"]["replicas"] = 3
    api.seed(CR_API, CRD_PLURAL, cr)
    _run(r.reconcile(cr))
    assert order == [4, 3]  # highest ordinal drains first
    sts = api.objects[("apps/v1", "default", "statefulsets", "rp")]
    assert sts["spec"]["replicas"] == 3


def test_adopts_existing_statefulset():
    """An sts that already exists (operator restart) is adopted and
    drifted fields are corrected without a create."""
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr(replicas=3, image="img:2"))
    drifted = desired_statefulset(ClusterSpec.from_cr(cr))
    drifted["spec"]["template"]["spec"]["containers"][0]["image"] = "img:OLD"
    drifted["status"] = {"readyReplicas": 3}
    api.seed("apps/v1", "statefulsets", drifted)
    api.seed("v1", "services", {"metadata": {"name": "rp"}, "spec": {}})

    _run(Reconciler(api).reconcile(cr))
    sts = api.objects[("apps/v1", "default", "statefulsets", "rp")]
    assert (
        sts["spec"]["template"]["spec"]["containers"][0]["image"] == "img:2"
    )
    assert ("create", "rp") not in api.writes
    # readyReplicas propagated from observed sts status
    status = api.objects[(CR_API, "default", CRD_PLURAL, "rp")]["status"]
    assert status["readyReplicas"] == 3


def test_bad_cr_rejected():
    with pytest.raises(ValueError):
        ClusterSpec.from_cr({"metadata": {}, "spec": {"replicas": 3}})
    with pytest.raises(ValueError):
        ClusterSpec.from_cr({"metadata": {"name": "x"}, "spec": {"replicas": 0}})


def test_operator_loop_converges():
    async def run():
        api = FakeKubeApi()
        api.seed(CR_API, CRD_PLURAL, _cr(replicas=2))
        op = Operator(api, interval_s=0.02)
        await op.start()
        for _ in range(100):
            if ("apps/v1", "default", "statefulsets", "rp") in api.objects:
                break
            await asyncio.sleep(0.02)
        await op.stop()
        assert ("apps/v1", "default", "statefulsets", "rp") in api.objects

    asyncio.run(run())


def test_generated_crd_and_cr_parse():
    """The CLI-emitted CRD/CR YAML must be valid and round-trip into
    the operator's ClusterSpec."""
    import yaml

    from redpanda_tpu_torch.cli import CLUSTER_CR_TEMPLATE, CRD_TEMPLATE

    crd = yaml.safe_load(CRD_TEMPLATE)
    assert crd["kind"] == "CustomResourceDefinition"
    assert crd["spec"]["group"] == GROUP
    v1 = crd["spec"]["versions"][0]
    assert v1["name"] == VERSION and v1["subresources"] == {"status": {}}
    props = v1["schema"]["openAPIV3Schema"]["properties"]["spec"]["properties"]
    # every ClusterSpec CR field is declared in the CRD schema
    assert set(props) >= {"replicas", "image", "storage", "extraArgs"}

    cr = yaml.safe_load(
        CLUSTER_CR_TEMPLATE.format(
            name="rp", namespace="prod", replicas=3, image="i:1", storage="5Gi"
        )
    )
    spec = ClusterSpec.from_cr(cr)
    assert (spec.name, spec.namespace, spec.replicas) == ("rp", "prod", 3)
    assert (spec.image, spec.storage) == ("i:1", "5Gi")


def test_reconcile_idempotent_status_too():
    """A fully converged cluster produces ZERO writes on re-reconcile
    (status included) — no apiserver watch churn at steady state."""
    api = FakeKubeApi()
    cr = api.seed(CR_API, CRD_PLURAL, _cr())
    _run(Reconciler(api).reconcile(cr))
    cr = api.objects[(CR_API, "default", CRD_PLURAL, "rp")]
    before = list(api.writes)
    _run(Reconciler(api).reconcile(cr))
    assert api.writes == before


def test_operator_loop_survives_api_failures():
    """A transient list() failure must not kill the control loop."""

    class FlakyApi(FakeKubeApi):
        def __init__(self):
            super().__init__()
            self.calls = 0

        async def list(self, api, ns, plural):
            self.calls += 1
            if self.calls == 1:
                raise KubeError(503, "apiserver blip")
            return await super().list(api, ns, plural)

    async def run():
        api = FlakyApi()
        api.seed(CR_API, CRD_PLURAL, _cr(replicas=1))
        op = Operator(api, interval_s=0.02)
        await op.start()
        for _ in range(100):
            if ("apps/v1", "default", "statefulsets", "rp") in api.objects:
                break
            await asyncio.sleep(0.02)
        await op.stop()
        assert api.calls >= 2
        assert ("apps/v1", "default", "statefulsets", "rp") in api.objects

    asyncio.run(run())


def test_http_kube_api_against_imposter():
    """Drive HttpKubeApi + Reconciler over a real HTTP apiserver
    imposter (the GET/list/create/replace/status wire path, bearer
    header included)."""
    import re as _re

    from redpanda_tpu_torch.httpd import HttpServer
    from redpanda_tpu_torch.operator import HttpKubeApi

    class ApiServerImposter(HttpServer):
        def __init__(self):
            super().__init__()
            self.store = FakeKubeApi()
            self.auth_headers: list[str] = []

        def _install_routes(self) -> None:
            obj = r"/(?:api/(v1)|apis/([\w./-]+))/namespaces/(\w+)/(\w+)"
            self.route("GET", obj + r"$", self._list)
            self.route("POST", obj + r"$", self._create)
            self.route("GET", obj + r"/([\w.-]+)$", self._get)
            self.route("PUT", obj + r"/([\w.-]+)$", self._replace)
            self.route("PUT", obj + r"/([\w.-]+)/status$", self._status)

        @staticmethod
        def _parts(m):
            api = m.group(1) or m.group(2)
            return api, m.group(3), m.group(4)

        async def _list(self, m, _q, _b):
            api, ns, plural = self._parts(m)
            return {"items": await self.store.list(api, ns, plural)}

        async def _get(self, m, _q, _b):
            from redpanda_tpu_torch.httpd import HttpError
            from redpanda_tpu_torch.operator import KubeError as KErr

            api, ns, plural = self._parts(m)
            try:
                return await self.store.get(api, ns, plural, m.group(5))
            except KErr as e:
                raise HttpError(e.status, str(e)) from None

        async def _create(self, m, _q, body):
            api, ns, plural = self._parts(m)
            return await self.store.create(api, ns, plural, self.json_body(body))

        async def _replace(self, m, _q, body):
            api, ns, plural = self._parts(m)
            return await self.store.replace(
                api, ns, plural, m.group(5), self.json_body(body)
            )

        async def _status(self, m, _q, body):
            api, ns, plural = self._parts(m)
            return await self.store.update_status(
                api, ns, plural, m.group(5), self.json_body(body).get("status", {})
            )

    async def run():
        srv = ApiServerImposter()
        await srv.start()
        try:
            srv.store.seed(CR_API, CRD_PLURAL, _cr(replicas=2))
            host, port = srv.address
            api = HttpKubeApi(host, port, token="sa-token", tls=False)
            await Reconciler(api).reconcile_all("default")
            sts = srv.store.objects[("apps/v1", "default", "statefulsets", "rp")]
            assert sts["spec"]["replicas"] == 2
            cr = srv.store.objects[(CR_API, "default", CRD_PLURAL, "rp")]
            assert cr["status"]["conditions"][0]["type"] == "Reconciled"
            await api._client.close()
        finally:
            await srv.stop()

    asyncio.run(run())


def test_reconcile_all_isolates_failures():
    """One broken CR must not stop the others from reconciling."""

    async def run():
        api = FakeKubeApi()
        api.seed(CR_API, CRD_PLURAL, _cr(name="good", replicas=1))
        api.seed(
            CR_API,
            CRD_PLURAL,
            {
                "apiVersion": CR_API,
                "kind": "Cluster",
                "metadata": {"name": "bad", "namespace": "default"},
                "spec": {"replicas": -1},
            },
        )
        await Reconciler(api).reconcile_all("default")
        assert ("apps/v1", "default", "statefulsets", "good") in api.objects
        assert ("apps/v1", "default", "statefulsets", "bad") not in api.objects

    asyncio.run(run())
