"""The port's HTTP control plane (``client/http_gateway.py``,
``client/http_apiserver.py``) against the JAX package's, on the CPU:
``tests/test_http_client.py``'s ten cases (CRUD and CRD, ``pods:bindmany``,
the restart fence and its failed-restart case, watch streams and their
scoping, the controller, the reflector across a restart, and the whole
stack with ``device="cpu"``) run through both packages, with the
reference's own assertions holding on the port and the observations of
the two equal. A cross-package case runs each package's client against
the other package's gateway: the stored documents and the watch event
sequence must be equal. Every comparison is exact (documents, names and
event types)."""

import http.client as hc
import importlib
import json
import queue as _q
import time
import types as pytypes

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
GROUP_LABEL = "group.batch.scheduler.tpu"

# metadata the server stamps per process (uids, clocks, resource versions)
_STAMPS = ("uid", "resource_version", "creation_timestamp")


def _pkg(name):
    ns = pytypes.SimpleNamespace(name=name)
    for attr, mod in (("types", "api.types"), ("apiserver", "client.apiserver"),
                      ("clientset", "client.clientset"),
                      ("http", "client.http_apiserver"),
                      ("gateway", "client.http_gateway"),
                      ("informers", "client.informers"),
                      ("controller", "controller.controller"),
                      ("cache", "cache.pg_cache"), ("scen", "sim.scenarios"),
                      ("labels", "utils.labels")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    ns.kw = {"device": "cpu"} if name.endswith("_torch") else {}
    return ns


def both(fn):
    """(reference, port) observations of ``fn(m)``."""
    return [fn(_pkg(name)) for name in PACKAGES]


class _Remote:
    """A gateway serving a fresh in-memory store, and a client on it."""

    def __init__(self, m, **client_kw):
        self.backing = m.apiserver.APIServer()
        self.server = m.gateway.serve_gateway(self.backing)
        self.host, self.port = self.server.server_address[:2]
        self.api = m.http.HTTPAPIServer(self.host, self.port, **client_kw)

    def close(self):
        self.api.close()
        self.server.shutdown()
        self.server.server_close()


def _remote(fn):
    def run(m):
        r = _Remote(m)
        try:
            return fn(m, r)
        finally:
            r.close()
    return run


def _pod(m, name, group="", namespace="default", labels=None):
    t = m.types
    lab = dict(labels or {})
    if group:
        lab[GROUP_LABEL] = group
    return t.Pod(
        metadata=t.ObjectMeta(name=name, namespace=namespace, uid=t.new_uid("pod"),
                              labels=lab),
        spec=t.PodSpec(containers=[t.Container.from_raw(requests={"cpu": 100})]),
    )


def _group(m, name, min_member):
    return m.scen.make_sim_group(name, min_member)


def _wait(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _plain(doc):
    """A stored document without its per-process stamps."""
    doc = json.loads(json.dumps(doc))
    meta = doc.get("metadata") or {}
    for k in _STAMPS:
        meta.pop(k, None)
    return doc


def test_label_constant_is_the_packages():
    assert {_pkg(p).labels.POD_GROUP_LABEL for p in PACKAGES} == {GROUP_LABEL}


# -- test_http_client.py's cases ----------------------------------------------


@_remote
def _crud(m, r):
    api = r.api
    out = [api.ensure_crd("podgroups.batch.scheduler.tpu", {"kind": "PodGroup"}),
           api.ensure_crd("podgroups.batch.scheduler.tpu"),
           "podgroups.batch.scheduler.tpu" in api.crds()]
    cs = m.clientset.Clientset(api)
    pg = cs.podgroups().create(_group(m, "web", 3))
    out.append(bool(pg.metadata.uid))
    out.append(cs.podgroups().get("web").spec.min_member)
    patched = cs.podgroups().patch("web", {"status": {"phase": "Pending"}})
    out += [patched.status.phase.value, patched.spec.min_member]
    with pytest.raises(m.apiserver.NotFoundError):
        cs.podgroups().get("nope")
    cs.pods().create(_pod(m, "web-0", group="web"))
    cs.pods().create(_pod(m, "loner"))
    members = cs.pods().list(label_selector={GROUP_LABEL: "web"})
    out.append([p.metadata.name for p in members])
    cs.podgroups().delete("web")
    with pytest.raises(m.apiserver.NotFoundError):
        cs.podgroups().get("web")
    out.append(sorted(_plain(d)["metadata"]["name"] for d in r.backing.list("Pod")))
    return out


def test_crud_and_crd_over_http():
    ref, port = both(_crud)
    assert port == ref == [True, False, True, True, 3, "Pending", 3, ["web-0"],
                           ["loner", "web-0"]]


@_remote
def _bind_many(m, r):
    api = r.api
    cs = m.clientset.Clientset(api)
    for name in ("bm-0", "bm-1", "bm-2"):
        cs.pods().create(_pod(m, name))
    out = [cs.pods().bind_many([("bm-0", "n1"), ("ghost", "n1"), ("bm-1", "n2")])]
    out += [cs.pods().get(n).spec.node_name or "" for n in ("bm-0", "bm-1", "bm-2")]
    api._batch_bind = False
    try:
        out.append(api.bind_pods("default", [("bm-2", "n3"), ("ghost", "n3")]))
    finally:
        api._batch_bind = True
    out.append(cs.pods().get("bm-2").spec.node_name)
    out.append(sorted(json.dumps(_plain(d), sort_keys=True) for d in r.backing.list("Pod")))
    return out


def test_bind_many_batched_over_http():
    ref, port = both(_bind_many)
    assert port == ref
    assert port[:6] == [["bm-0", "bm-1"], "n1", "n2", "", ["bm-2"], "n3"]


@_remote
def _fence(m, r):
    backing = r.backing
    cs = m.clientset.Clientset(r.api)
    for name in ("fz-0", "fz-1"):
        cs.pods().create(_pod(m, name))
    old_epoch = backing._bind_epoch
    out = [old_epoch >= 1,
           backing.bind_pods("default", [("fz-0", "n1")], epoch=old_epoch)]
    backing.advance_bind_epoch()
    out.append(backing.bind_pods("default", [("fz-1", "n2")], epoch=old_epoch))
    out.append(cs.pods().get("fz-1").spec.node_name or "")
    out.append(backing.bind_pods("default", [("fz-1", "n2")]))
    out.append(cs.pods().get("fz-1").spec.node_name)
    return out


def test_gateway_restart_fences_zombie_binds():
    ref, port = both(_fence)
    assert port == ref == [True, ["fz-0"], [], "", ["fz-1"], "n2"]


@_remote
def _failed_restart(m, r):
    backing = r.backing
    cs = m.clientset.Clientset(r.api)
    cs.pods().create(_pod(m, "fb-0"))
    epoch_before = backing._bind_epoch
    with pytest.raises(OSError):
        m.gateway.serve_gateway(backing, r.api.host, r.api.port)  # port busy
    return [backing._bind_epoch == epoch_before,
            cs.pods().bind_many([("fb-0", "n1")])]


def test_failed_gateway_restart_does_not_burn_the_fence():
    ref, port = both(_failed_restart)
    assert port == ref == [True, ["fb-0"]]


@pytest.mark.parametrize("verb", ["bindmany", "patch", "create"])
def test_a_lost_answer_is_resent_only_where_safe(verb, monkeypatch):
    """A request the server applied but whose answer was lost (a restart
    cuts the connection) is sent once more on a fresh connection only where
    a re-send cannot change the outcome: a merge PATCH and, in the port,
    ``pods:bindmany`` (a bind sets absolute values; the scheduler's every
    bind takes it), never a create."""
    m = _pkg(PACKAGES[1])
    r = _Remote(m, qps=0)
    try:
        cs = m.clientset.Clientset(r.api)
        cs.pods().create(_pod(m, "rs-0"))
        real = hc.HTTPConnection.getresponse
        lost = []

        def getresponse(conn):
            resp = real(conn)
            if not lost:
                lost.append(resp.read())  # the server applied it
                raise ConnectionResetError("answer lost")
            return resp
        monkeypatch.setattr(hc.HTTPConnection, "getresponse", getresponse)
        if verb == "create":
            with pytest.raises(ConnectionResetError):
                cs.pods().create(_pod(m, "rs-1"))
            assert r.backing.get("Pod", "default", "rs-1")["metadata"]["name"] == "rs-1"
        elif verb == "bindmany":
            assert r.api.bind_pods("default", [("rs-0", "n1")]) == ["rs-0"]
        else:
            r.api.patch("Pod", "default", "rs-0", {"spec": {"node_name": "n1"}})
        monkeypatch.undo()
        assert len(lost) == 1
        if verb != "create":
            assert r.backing.get("Pod", "default", "rs-0")["spec"]["node_name"] == "n1"
    finally:
        r.close()


@_remote
def _watch(m, r):
    api = r.api
    W = m.apiserver.WatchEvent
    cs = m.clientset.Clientset(api)
    cs.podgroups().create(_group(m, "before", 1))
    events = api.watch("PodGroup", replay=True)
    seen = []
    ev = events.get(timeout=5.0)
    seen.append((ev.type, ev.obj["metadata"]["name"]))
    cs.podgroups().create(_group(m, "after", 2))
    ev = events.get(timeout=5.0)
    seen.append((ev.type, ev.obj["metadata"]["name"]))
    cs.podgroups().patch("after", {"status": {"phase": "Pending"}})
    ev = events.get(timeout=5.0)
    seen.append((ev.type, ev.obj["status"]["phase"]))
    cs.podgroups().delete("after")
    ev = events.get(timeout=5.0)
    seen.append((ev.type, ev.obj["metadata"]["name"]))
    api.stop_watch("PodGroup", events)
    cs.podgroups().create(_group(m, "silent", 1))
    with pytest.raises(_q.Empty):
        events.get(timeout=0.5)
    assert seen[-1][0] == W.DELETED
    return seen


def test_watch_streams_over_http():
    ref, port = both(_watch)
    assert port == ref == [("ADDED", "before"), ("ADDED", "after"),
                           ("MODIFIED", "Pending"), ("DELETED", "after")]


@_remote
def _controller(m, r):
    api = r.api
    cs = m.clientset.Clientset(api)
    informers = m.informers.SharedInformerFactory(api)
    pg_informer = informers.pod_groups()
    cache = m.cache.PGStatusCache()
    controller = m.controller.PodGroupController(
        client=cs, pg_informer=pg_informer, pg_cache=cache,
        reject_pod=lambda uid: None, add_to_backoff=lambda name: None,
        resync_seconds=0.1,
    )
    informers.start()
    assert informers.wait_for_cache_sync(10.0)
    controller.run(workers=2)
    try:
        cs.podgroups().create(_group(m, "remote-gang", 2))
        pending = _wait(lambda: cs.podgroups().get("remote-gang").status.phase.value
                        == "Pending", timeout=10.0)
        cached = _wait(lambda: cache.get("default/remote-gang") is not None)
        return [pending, cached]
    finally:
        controller.stop()
        informers.stop()


def test_controller_reconciles_over_http():
    ref, port = both(_controller)
    assert port == ref == [True, True]


def _reflector(m):
    to_dict = m.types.to_dict
    backing = m.apiserver.APIServer()
    server = m.gateway.serve_gateway(backing)
    host, port = server.server_address[:2]
    client = m.http.HTTPAPIServer(host, port)
    try:
        backing.create("PodGroup", to_dict(_group(m, "keep", 2)))
        backing.create("PodGroup", to_dict(_group(m, "doomed", 2)))
        informers = m.informers.SharedInformerFactory(client)
        inf = informers.informer("PodGroup")
        inf.start()
        assert inf.wait_for_sync(10.0)
        assert _wait(lambda: len(inf.list("default")) == 2)
        server.shutdown()
        server.server_close()
        backing.delete("PodGroup", "default", "doomed")
        backing.create("PodGroup", to_dict(_group(m, "fresh", 3)))
        server = m.gateway.serve_gateway(backing, host=host, port=port)
        names = lambda: sorted(g.metadata.name for g in inf.list("default"))  # noqa: E731
        assert _wait(lambda: names() == ["fresh", "keep"], timeout=15.0), names()
        inf.stop()
        return names()
    finally:
        client.close()
        server.shutdown()
        server.server_close()


def test_watch_reflector_survives_gateway_restart():
    ref, port = both(_reflector)
    assert port == ref == ["fresh", "keep"]


def _watch_lines(resp, budget=40, stop_at=None):
    out = []
    while budget > 0:
        line = resp.fp.readline()
        budget -= 1
        if not line:
            break
        if not line.strip():
            continue
        ev = json.loads(line)
        out.append(ev)
        if stop_at is not None and stop_at(ev):
            break
    return out


@_remote
def _scoping(m, r):
    to_dict = m.types.to_dict
    conn = hc.HTTPConnection(r.api.host, r.api.port)
    conn.request("GET",
                 "/api/v1/namespaces/nsa/pods?watch=1&replay=1&labelSelector=app%3Dweb")
    resp = conn.getresponse()
    try:
        docs = []
        for name, ns, app in (("in-scope", "nsa", "web"), ("wrong-ns", "nsb", "web"),
                              ("wrong-label", "nsa", "db")):
            d = to_dict(_pod(m, name))
            d["metadata"]["namespace"] = ns
            d["metadata"]["labels"] = {"app": app}
            docs.append(d)
        for d in docs:
            r.backing.create("Pod", d)
        seen = [ev["object"]["metadata"]["name"] for ev in _watch_lines(resp)
                if ev.get("type") in ("ADDED", "MODIFIED")]
        assert seen and set(seen) == {"in-scope"}
        return sorted(set(seen))
    finally:
        resp.close()
        conn.close()


def test_watch_namespace_and_selector_scoping():
    ref, port = both(_scoping)
    assert port == ref == ["in-scope"]


@_remote
def _transitions(m, r):
    d = m.types.to_dict(_pod(m, "mover"))
    d["metadata"]["labels"] = {"app": "db"}
    r.backing.create("Pod", d)
    conn = hc.HTTPConnection(r.api.host, r.api.port)
    conn.request("GET", "/api/v1/pods?watch=1&replay=1&labelSelector=app%3Dweb")
    resp = conn.getresponse()
    try:
        _watch_lines(resp, budget=100, stop_at=lambda ev: ev.get("type") == "BOOKMARK")
        not_bookmark = lambda ev: ev.get("type") != "BOOKMARK"  # noqa: E731
        out = []
        for app in ("web", "db"):
            r.backing.patch("Pod", "default", "mover", {"metadata": {"labels": {"app": app}}})
            ev = _watch_lines(resp, stop_at=not_bookmark)[-1]
            out.append((ev["type"], ev["object"]["metadata"]["name"]))
        return out
    finally:
        resp.close()
        conn.close()


def test_watch_scope_transitions_emit_added_and_deleted():
    ref, port = both(_transitions)
    assert port == ref == [("ADDED", "mover"), ("DELETED", "mover")]


def _full_stack(m):
    backing = m.apiserver.APIServer()
    server = m.gateway.serve_gateway(backing)
    host, port = server.server_address[:2]
    api = m.http.HTTPAPIServer(host, port, qps=500.0, burst=200)
    sim = importlib.import_module(f"{m.name}.sim")
    cluster = sim.SimCluster(scorer="oracle", api=api, **m.kw)
    nodes, groups, pods_by_group = m.scen.race_scenario()
    cluster.add_nodes(nodes)
    for pg in groups:
        cluster.create_group(pg)
    cluster.start()
    try:
        for pods in pods_by_group.values():
            cluster.create_pods(pods)
        assert cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= 5,
                                timeout=60.0), cluster.scheduler.stats
        running = cluster.wait_for_group_phase(
            "web-group-race1", m.types.PodGroupPhase.RUNNING, timeout=30.0)
        bound2 = [p.metadata.name for p in cluster.member_pods("web-group-race2")
                  if p.spec.node_name]
        # the whole-gang poll the CLI's settle loop reads, over the wire
        counts = cluster.bound_member_counts() if m.name.endswith("_torch") else None
        return [running, bound2, cluster.scheduler.stats["binds"], counts]
    finally:
        cluster.stop()
        api.close()
        server.shutdown()
        server.server_close()


def test_full_stack_schedules_over_http():
    ref, port = both(_full_stack)
    assert ref[:3] == port[:3] == [True, [], 5]
    assert port[3] == {("default", "web-group-race1"): 5}


# -- across the packages -----------------------------------------------------


def _cross_drive(m_client, m_server):
    """``m_client``'s HTTPAPIServer against ``m_server``'s gateway: one
    watch opened first, then a fixed sequence of writes."""
    backing = m_server.apiserver.APIServer()
    server = m_server.gateway.serve_gateway(backing)
    host, port = server.server_address[:2]
    api = m_client.http.HTTPAPIServer(host, port, qps=0)
    try:
        events = api.watch("Pod", replay=True)
        cs = m_client.clientset.Clientset(api)
        # the stream is subscribed once a sentinel pod's event arrives:
        # every write after that streams live, in order
        cs.pods().create(_pod(m_client, "sentinel"))
        while events.get(timeout=10.0).obj["metadata"]["name"] != "sentinel":
            pass
        cs.podgroups().create(_group(m_client, "g", 2))
        for i in range(3):
            cs.pods().create(_pod(m_client, f"g-{i}", group="g"))
        bound = cs.pods().bind_many([("g-0", "n1"), ("g-1", "n2"), ("ghost", "n1")])
        cs.pods().patch("g-2", {"metadata": {"labels": {"tier": "x"}}})
        cs.pods().delete("g-2")
        cs.podgroups().patch("g", {"status": {"phase": "Pending"}})
        # (the sentinel's create can also arrive twice: in the replay and
        # live, the gateway's level-based contract)
        seq = []
        while len(seq) < 7:
            ev = events.get(timeout=10.0)
            if ev.obj["metadata"]["name"] != "sentinel":
                seq.append((ev.type, ev.obj["metadata"]["name"],
                            (ev.obj.get("spec") or {}).get("node_name") or ""))
        api.stop_watch("Pod", events)
        stored = {kind: sorted(json.dumps(_plain(d), sort_keys=True)
                               for d in backing.list(kind))
                  for kind in ("Pod", "PodGroup")}
        listed = sorted(d["metadata"]["name"] for d in api.list(
            "Pod", "default", {GROUP_LABEL: "g"}))
        return bound, seq, stored, listed
    finally:
        api.close()
        server.shutdown()
        server.server_close()


def test_cross_package_client_and_gateway():
    """The JAX package's client against the port's gateway, and the port's
    client against the JAX package's gateway: the same writes leave equal
    stored documents (stamps aside) and stream the same watch events."""
    ref, port = (_pkg(p) for p in PACKAGES)
    a = _cross_drive(ref, port)
    b = _cross_drive(port, ref)
    same = _cross_drive(port, port)
    assert a == b == same
    bound, seq, stored, listed = a
    assert bound == ["g-0", "g-1"] and listed == ["g-0", "g-1"]
    assert seq == [("ADDED", "g-0", ""), ("ADDED", "g-1", ""), ("ADDED", "g-2", ""),
                   ("MODIFIED", "g-0", "n1"), ("MODIFIED", "g-1", "n2"),
                   ("MODIFIED", "g-2", ""), ("DELETED", "g-2", "")]
