"""The port's wire protocol (batch_scheduler_tpu_torch/service/protocol.py)
against the JAX package's: for seeded inputs every frame the port packs is
byte-identical to the reference's, each package unpacks the other's bytes
to equal fields, and the native C++ client's constants match the port's
protocol."""

import os
import re

import numpy as np
import pytest

from batch_scheduler_tpu.service import protocol as jproto
from batch_scheduler_tpu_torch.service import protocol as tproto

SEEDS = (0, 1, 2)


def _schedule_fields(rng, n, g, r, mask_rows):
    return dict(
        alloc=rng.integers(0, 2**30, size=(n, r), dtype=np.int32),
        requested=rng.integers(0, 2**20, size=(n, r), dtype=np.int32),
        group_req=rng.integers(0, 2**16, size=(g, r), dtype=np.int32),
        remaining=rng.integers(0, 64, size=g, dtype=np.int32),
        fit_mask=rng.random((mask_rows, n)) < 0.7,
        group_valid=rng.random(g) < 0.9,
        order=rng.permutation(g).astype(np.int32),
        min_member=rng.integers(1, 64, size=g, dtype=np.int32),
        scheduled=rng.integers(0, 8, size=g, dtype=np.int32),
        matched=rng.integers(0, 8, size=g, dtype=np.int32),
        ineligible=rng.random(g) < 0.1,
        creation_rank=rng.permutation(g).astype(np.int32),
    )


def _delta_fields(rng, n, g, r, mask_rows):
    m_nodes, m_groups = int(rng.integers(0, n)), int(rng.integers(0, g))
    base = _schedule_fields(rng, n, g, r, mask_rows)
    for k in ("alloc", "requested", "group_req"):
        base.pop(k)
    return dict(
        node_idx=rng.choice(n, size=m_nodes, replace=False).astype(np.int32),
        node_rows=rng.integers(0, 2**20, size=(m_nodes, r), dtype=np.int32),
        group_idx=rng.choice(g, size=m_groups, replace=False).astype(np.int32),
        group_rows=rng.integers(0, 2**16, size=(m_groups, r), dtype=np.int32),
        n=n, g=g, r=r, **base,
    )


def _response_fields(rng, g, k, batch_seq):
    return dict(
        gang_feasible=rng.random(g) < 0.5,
        placed=rng.random(g) < 0.5,
        progress=rng.integers(0, 1000, size=g, dtype=np.int32),
        best=int(rng.integers(0, g)),
        best_exists=bool(rng.random() < 0.5),
        assignment_nodes=rng.integers(0, 5000, size=(g, k), dtype=np.int32),
        assignment_counts=rng.integers(0, 10, size=(g, k), dtype=np.int32),
        batch_seq=batch_seq,
    )


def _assert_fields_equal(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


_REQ_NAMES = tuple(jproto.ScheduleRequest.__dataclass_fields__)
_RESP_NAMES = tuple(jproto.ScheduleResponse.__dataclass_fields__)
_DELTA_NAMES = tuple(jproto.DeltaScheduleRequest.__dataclass_fields__)


def test_port_protocol_constants_match_reference():
    assert tproto.MAGIC == jproto.MAGIC
    assert tproto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES
    assert tproto.ROW_KINDS == jproto.ROW_KINDS
    assert tproto.DELTA_KEYFRAME == jproto.DELTA_KEYFRAME
    assert tproto.DELTA_ROWS == jproto.DELTA_ROWS
    assert tproto.TENANT_LABEL_MAX_BYTES == jproto.TENANT_LABEL_MAX_BYTES
    ref_types = {k: v for k, v in vars(jproto.MsgType).items() if k.isupper()}
    port_types = {k: v for k, v in vars(tproto.MsgType).items() if k.isupper()}
    assert port_types == ref_types
    assert sorted(ref_types.values()) == list(range(1, 19))
    assert tproto.__all__ == jproto.__all__


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mask_rows", ("broadcast", "per_group"))
def test_schedule_request_frames_identical(seed, mask_rows):
    rng = np.random.default_rng(seed)
    n, g, r = int(rng.integers(1, 300)), int(rng.integers(1, 70)), 5
    fields = _schedule_fields(rng, n, g, r, 1 if mask_rows == "broadcast" else g)
    port = tproto.pack_schedule_request(tproto.ScheduleRequest(**fields))
    ref = jproto.pack_schedule_request(jproto.ScheduleRequest(**fields))
    assert port == ref
    _assert_fields_equal(tproto.unpack_schedule_request(ref),
                         jproto.unpack_schedule_request(port), _REQ_NAMES)
    # the keyframe body IS a schedule request
    assert tproto.pack_delta_keyframe(seed + 7, tproto.ScheduleRequest(**fields)) \
        == jproto.pack_delta_keyframe(seed + 7, jproto.ScheduleRequest(**fields))


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_response_frames_identical(seed):
    rng = np.random.default_rng(100 + seed)
    g, k = int(rng.integers(1, 70)), int(rng.integers(1, 17))
    fields = _response_fields(rng, g, k, batch_seq=int(rng.integers(0, 2**31)))
    port = tproto.pack_schedule_response(tproto.ScheduleResponse(**fields))
    ref = jproto.pack_schedule_response(jproto.ScheduleResponse(**fields))
    assert port == ref
    _assert_fields_equal(tproto.unpack_schedule_response(ref),
                         jproto.unpack_schedule_response(port), _RESP_NAMES)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mask_rows", ("broadcast", "per_group"))
def test_delta_frames_identical(seed, mask_rows):
    rng = np.random.default_rng(200 + seed)
    n, g, r = int(rng.integers(2, 300)), int(rng.integers(2, 70)), 5
    fields = _delta_fields(rng, n, g, r, 1 if mask_rows == "broadcast" else g)
    port = tproto.pack_delta_rows(3, 4, tproto.DeltaScheduleRequest(**fields))
    ref = jproto.pack_delta_rows(3, 4, jproto.DeltaScheduleRequest(**fields))
    assert port == ref
    for payload, unpack, other in ((ref, tproto, jproto), (port, jproto, tproto)):
        kind, base, new, body = unpack.unpack_delta_schedule_request(payload)
        assert (kind, base, new) == (other.DELTA_ROWS, 3, 4)
        _assert_fields_equal(body, other.DeltaScheduleRequest(**fields), _DELTA_NAMES)
    req = _schedule_fields(rng, n, g, r, 1)
    keyframe = jproto.pack_delta_keyframe(9, jproto.ScheduleRequest(**req))
    kind, base, new, body = tproto.unpack_delta_schedule_request(keyframe)
    assert (kind, base, new) == (tproto.DELTA_KEYFRAME, 0, 9)
    _assert_fields_equal(body, tproto.ScheduleRequest(**req), _REQ_NAMES)


def test_small_frames_identical():
    cases = [
        ("pack_row_request", ("scores", 17, 42)),
        ("pack_row_request", ("capacity", 0, 0)),
        ("pack_deadline", (1,)),
        ("pack_deadline", (0xFFFFFFFF,)),
        ("pack_trace", ("0123456789abcdef", "89abcdef")),
        ("pack_trace", ("fedcba9876543210", "")),
        ("pack_trace_info", ("0123456789abcdef",
                             [{"name": "oracle.schedule", "dur": 1.5}],
                             {"device": "cuda:0", "n": 3})),
        ("pack_audit_id", ("00112233aabbccdd",)),
        ("pack_policy_info", ("a1b2c3d4e5f60718",)),
        ("pack_tenant", ("team-a",)),
        # over the byte cap, a codepoint split at the cap drops cleanly
        ("pack_tenant", ("ü" * 40,)),
        ("pack_busy", (250, "coalescer saturated")),
        ("pack_draining", (200, "10.0.0.2:9090,10.0.0.3:9090")),
        ("pack_draining", (0, "")),
        ("pack_delta_resync", ("generation gap: mirror at 3, delta base 5",)),
    ]
    for name, args in cases:
        port = getattr(tproto, name)(*args)
        assert port == getattr(jproto, name)(*args), name
        unpack = name.replace("pack_", "unpack_")
        assert getattr(tproto, unpack)(port) == getattr(jproto, unpack)(port), name


def test_frame_header_and_validation_identical():
    class Sink:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += b

    class Source:
        def __init__(self, data):
            self.data = data

        def recv(self, n):
            out, self.data = self.data[:n], self.data[n:]
            return out

    for msg_type, payload in ((tproto.MsgType.PING, b""),
                              (tproto.MsgType.ERROR, b"oracle error")):
        port, ref = Sink(), Sink()
        tproto.write_frame(port, msg_type, payload)
        jproto.write_frame(ref, msg_type, payload)
        assert port.data == ref.data
        assert tproto.read_frame(Source(ref.data)) == (msg_type, payload)
    with pytest.raises(ValueError, match="bad frame magic"):
        tproto.read_frame(Source(b"XXXX" + port.data[4:]))
    for bad in ((tproto.pack_deadline, 0), (tproto.pack_trace, "short"),
                (tproto.pack_audit_id, "x"), (tproto.pack_tenant, "")):
        with pytest.raises(ValueError):
            bad[0](bad[1])
    for msg in ("stale batch: row for seq 1, current 2",
                "row request before any batch", "row index 9 out of range 2"):
        assert tproto.is_stale_batch_message(msg) == jproto.is_stale_batch_message(msg)


def test_native_client_protocol_constants_match_port():
    """The native C++ client (native/bsp_client.cpp, the Go plugin's
    stand-in) speaks the port's protocol: its magic and message types
    equal the port's constants."""
    src = open(
        os.path.join(os.path.dirname(__file__), "..", "native", "bsp_client.cpp")
    ).read()
    magic = re.search(
        r"kMagic\[4\]\s*=\s*\{'(.)',\s*'(.)',\s*'(.)',\s*'(.)'\}", src
    )
    assert magic, "kMagic not found in bsp_client.cpp"
    assert "".join(magic.groups()).encode() == tproto.MAGIC
    want = {
        "kScheduleReq": tproto.MsgType.SCHEDULE_REQ,
        "kScheduleResp": tproto.MsgType.SCHEDULE_RESP,
        "kRowReq": tproto.MsgType.ROW_REQ,
        "kRowResp": tproto.MsgType.ROW_RESP,
        "kPing": tproto.MsgType.PING,
        "kPong": tproto.MsgType.PONG,
        "kError": tproto.MsgType.ERROR,
    }
    for name, value in want.items():
        m = re.search(rf"{name}\s*=\s*(\d+)", src)
        assert m, f"{name} not found in bsp_client.cpp"
        assert int(m.group(1)) == value, f"{name}: C++ {m.group(1)} != port {value}"
