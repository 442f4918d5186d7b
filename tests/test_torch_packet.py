"""The port's CXL.mem flit codec against the JAX package's, bit for bit.

The packet cases of `tests/test_protocol.py` on both packages, with every
M2S and S2M header word compared bitwise (the reference's uint32 words
are held in int64 by the port), and its roundtrip property on seeded
NumPy draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packet as jpacket
from repro_torch.core import packet as tpacket


def same_words(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def same_fields(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy().astype(np.int64),
                              np.asarray(want[k]).astype(np.int64)), k


def both_packetize(addr, wr, **kw):
    return (tpacket.rc_packetize(torch.from_numpy(addr),
                                 torch.from_numpy(wr), **kw),
            jpacket.rc_packetize(jnp.asarray(addr), jnp.asarray(wr), **kw))


def test_codecs_have_the_reference_layout():
    for t, j in ((tpacket.M2S_CODEC, jpacket.M2S_CODEC),
                 (tpacket.S2M_CODEC, jpacket.S2M_CODEC)):
        assert t.fields == j.fields and t.n_words == j.n_words
        assert t.offsets() == j.offsets() and t.total_bits == j.total_bits
    assert (tpacket.CH_M2S_REQ, tpacket.CH_M2S_RWD, tpacket.CH_S2M_NDR,
            tpacket.CH_S2M_DRS, tpacket.SLOT_WIRE_BYTES) == \
        (jpacket.CH_M2S_REQ, jpacket.CH_M2S_RWD, jpacket.CH_S2M_NDR,
         jpacket.CH_S2M_DRS, jpacket.SLOT_WIRE_BYTES)


def test_m2s_roundtrip_mixed():
    addr = np.arange(64, dtype=np.int32) * 7
    wr = np.asarray([i % 3 == 0 for i in range(64)])
    got, want = both_packetize(addr, wr)
    same_words(got["headers"], want["headers"])
    assert np.array_equal(got["slots"].numpy(), np.asarray(want["slots"]))
    dec = tpacket.ep_depacketize(got["headers"])
    same_fields(dec, jpacket.ep_depacketize(want["headers"]))
    assert bool(dec["legal"].all())
    assert np.array_equal(dec["address"].numpy(), addr)
    assert np.array_equal(dec["is_write"].numpy(), wr)


def test_s2m_responses_match_request_kind():
    addr = np.arange(8, dtype=np.int32)
    wr = np.asarray([0, 1] * 4, bool)
    got, want = both_packetize(addr, wr)
    nxm = np.asarray([0, 0, 1, 0, 0, 0, 1, 1], bool)
    for kw in ({}, {"dev_load": 2, "nxm": nxm}):
        s2m = tpacket.ep_respond(got["headers"],
                                 **{k: torch.from_numpy(v)
                                    if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
        js2m = jpacket.ep_respond(want["headers"],
                                  **{k: jnp.asarray(v) for k, v in
                                     kw.items()})
        same_words(s2m["headers"], js2m["headers"])
        assert int(s2m["wire_bytes"]) == int(js2m["wire_bytes"])
        done = tpacket.rc_complete(s2m["headers"])
        same_fields(done, jpacket.rc_complete(js2m["headers"]))
        assert bool(done["legal"].all())
        # writes -> NDR Cmp (no data); reads -> DRS MemData
        assert np.array_equal(done["is_read_data"].numpy(), ~wr)
        # tags survive the round trip (completion matching)
        assert np.array_equal(done["tag"].numpy(), np.arange(8))


def test_wire_accounting_read_write_asymmetry():
    addr = np.zeros(10, np.int32)
    reads, jreads = both_packetize(addr, np.zeros(10, bool))
    writes, jwrites = both_packetize(addr, np.ones(10, bool), ld_id=3)
    same_words(writes["headers"], jwrites["headers"])
    # a write carries 64B payload in M2S; a read is header-only
    assert int(writes["wire_bytes"]) == 5 * int(reads["wire_bytes"]) == \
        int(jwrites["wire_bytes"])
    assert reads["wire_bytes"].dtype == torch.int32
    m2s, s2m = tpacket.roundtrip_wire_bytes(10, 0)
    assert (m2s, s2m) == jpacket.roundtrip_wire_bytes(10, 0)
    assert m2s == int(reads["wire_bytes"])
    assert s2m == 10 * 5 * tpacket.SLOT_WIRE_BYTES
    assert tpacket.roundtrip_wire_bytes(3, 7) == \
        jpacket.roundtrip_wire_bytes(3, 7)


@pytest.mark.parametrize("seed", range(6))
def test_codec_roundtrip_property(seed):
    """Random request lists (1-32 requests, line indices below 2**30,
    random tags and logical devices) roundtrip, with the reference's
    headers; the seeded twin of the reference's hypothesis property."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 33))
    addr = rng.integers(0, 2**30, n).astype(np.int32)
    wr = rng.random(n) < 0.5
    tags = rng.integers(0, 2**16, n).astype(np.int32)
    ld = rng.integers(0, 16, n).astype(np.int32)
    got = tpacket.rc_packetize(torch.from_numpy(addr), torch.from_numpy(wr),
                               tags=torch.from_numpy(tags),
                               ld_id=torch.from_numpy(ld))
    want = jpacket.rc_packetize(jnp.asarray(addr), jnp.asarray(wr),
                                tags=jnp.asarray(tags), ld_id=jnp.asarray(ld))
    same_words(got["headers"], want["headers"])
    dec = tpacket.ep_depacketize(got["headers"])
    assert bool(dec["legal"].all())
    assert np.array_equal(dec["address"].numpy(), addr)
    assert np.array_equal(dec["tag"].numpy(), tags)
    assert np.array_equal(dec["ld_id"].numpy(), ld)


def test_values_wrap_to_their_field_width_as_in_the_reference():
    # negative line indices wrap through uint32; tags over 16 bits are cut
    addr = np.array([-1, -2**31, 2**31 - 1, 0], np.int32)
    wr = np.array([1, 0, 1, 0], bool)
    tags = np.array([2**16 + 5, -1, 7, 2**20], np.int32)
    got = tpacket.rc_packetize(torch.from_numpy(addr), torch.from_numpy(wr),
                               tags=torch.from_numpy(tags))
    want = jpacket.rc_packetize(jnp.asarray(addr), jnp.asarray(wr),
                                tags=jnp.asarray(tags))
    same_words(got["headers"], want["headers"])
    same_fields(tpacket.ep_depacketize(got["headers"]),
                jpacket.ep_depacketize(want["headers"]))
    with pytest.raises(KeyError):
        tpacket.M2S_CODEC.pack({"nope": torch.zeros(2)})
    with pytest.raises(ValueError):
        tpacket.M2S_CODEC.pack({})
