"""The port's device transcript held against the JAX package's and hashlib.

``multilinear_tpu_torch.device_transcript`` keeps the Fiat-Shamir state of
the rounds in a device tensor; its plain functions run here on CPU tensors
and are what the round-scalars kernel is held against on the card.  They are
compared with ``multilinear_tpu.device_transcript`` (word-aligned absorbs
only: the JAX side refuses others) and with ``hashlib`` (any byte fill), and
the round's scalars with the JAX package's ``pcs._round_scalars``.  Every
comparison is exact.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import device_transcript as jdt
from multilinear_tpu import pcs as jpcs
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import device_transcript as dtr
from multilinear_tpu_torch.field import limbs, ops
from multilinear_tpu_torch.field.scalar import P, Fp
from multilinear_tpu_torch.sha256 import digest_to_bytes
from multilinear_tpu_torch.transcript import Sha256Midstate, Transcript

_j_absorb = jax.jit(jdt.absorb_words)
_j_digest = jax.jit(jdt.digest_words)
_j_challenge = jax.jit(jdt.challenge)
_j_round_scalars = jax.jit(jpcs._round_scalars)


def _same_as_jax(state: torch.Tensor, jstate) -> bool:
    """Equal midstates: chaining words, partial block words, fill, length."""
    st, buf, nwords, total_words = (np.asarray(x) for x in jstate)
    w = state.numpy().view(np.uint32)
    return (np.array_equal(w[:8], st) and np.array_equal(w[8:24], buf)
            and int(w[24]) == 4 * int(nwords) and int(w[25]) == 4 * int(total_words))


def _jax_digest(jstate) -> bytes:
    return np.asarray(_j_digest(jstate)).astype(">u4").tobytes()


def test_fresh_state_matches_jax_and_hashlib():
    state = dtr.fresh_state()
    assert state.shape == (dtr.STATE_WORDS,) and state.dtype == torch.int32
    assert _same_as_jax(state, jdt.fresh_state())
    assert dtr.digest(state) == _jax_digest(jdt.fresh_state()) == hashlib.sha256().digest()


@pytest.mark.parametrize("size", [8, 16, 32])
def test_absorbs_match_jax_and_hashlib(size):
    """Twenty absorbs of ``size`` bytes cross block boundaries at every
    word-aligned fill; state and digest agree after each."""
    rng = np.random.default_rng(size)
    state, jstate, host = dtr.fresh_state(), jdt.fresh_state(), hashlib.sha256()
    for _ in range(20):
        data = rng.bytes(size)
        state = dtr.absorb(state, data)
        jstate = _j_absorb(jstate, jnp.asarray(np.frombuffer(data, ">u4").astype(np.uint32)))
        host.update(data)
        assert _same_as_jax(state, jstate)
        assert dtr.digest(state) == _jax_digest(jstate) == host.copy().digest()


def test_challenge_matches_jax_and_the_host_transcript():
    """Field elements absorbed as 16 LE bytes; the challenge is the first 16
    digest bytes mod p - including 0 and p - 1 among the absorbed values."""
    rng = np.random.default_rng(3)
    values = [0, P - 1, 1] + [int.from_bytes(rng.bytes(16), "little") % P for _ in range(9)]
    state, jstate, host = dtr.fresh_state(), jdt.fresh_state(), Transcript()
    for v in values:
        state = dtr.absorb_field(state, limbs.pack_int(v))
        jstate = _j_absorb(jstate, jnp.asarray(np.frombuffer(Fp(v).to_bytes(), ">u4").astype(np.uint32)))
        host.absorb(Fp(v).to_bytes())
        want = host.next_challenge()
        assert limbs.unpack_int(dtr.challenge(state)) == want.v
        assert jlimbs.unpack_int(np.asarray(_j_challenge(jstate))) == want.v
    assert _same_as_jax(state, jstate)


@pytest.mark.parametrize("prefix", [0, 4, 48, 56, 60, 64, 100])
def test_state_hop_round_trip_matches_jax(prefix):
    """host -> device -> host at word-aligned fills: the exported state is
    the JAX package's, and the stream continues as if it had stayed."""
    data = bytes(range(256))[:prefix]
    host, jhost = Transcript(), JTranscript()
    host.absorb(data)
    jhost.absorb(data)
    state = dtr.state_from_host(host)
    assert _same_as_jax(state, jdt.state_from_host(jhost))
    state = dtr.absorb_words(state, torch.tensor([0x01020304, -1], dtype=torch.int32))
    back = dtr.state_to_host(state)
    ref = hashlib.sha256(data + bytes([1, 2, 3, 4, 255, 255, 255, 255]))
    assert back.random() == ref.digest()
    back.absorb(b"tail")
    ref.update(b"tail")
    assert back.random() == ref.digest()
    assert host.random() == hashlib.sha256(data).digest(), "exporting does not move the host stream"


@pytest.mark.parametrize("lengths", [[1], [3, 16], [5, 32, 7], [13, 13, 13, 13, 13], [63, 1, 64, 2], [55], [56]])
def test_unaligned_fills_match_hashlib(lengths):
    """Byte-granular absorbs and hops at any fill (the JAX device transcript
    refuses these): each prefix exported, absorbed on the device state,
    imported back, all against hashlib."""
    rng = np.random.default_rng(sum(lengths))
    host, ref = Transcript(), hashlib.sha256()
    state = dtr.state_from_host(host)
    for n in lengths:
        data = rng.bytes(n)
        state = dtr.absorb(state, torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
        host.absorb(data)
        ref.update(data)
        assert dtr.digest(state) == ref.digest() == host.random()
        assert torch.equal(dtr.state_from_host(host), state)
        assert dtr.state_to_host(state).random() == ref.digest()


def test_midstate_rejects_what_is_not_one():
    with pytest.raises(ValueError):
        Sha256Midstate(buf=b"x" * 64)
    with pytest.raises(ValueError):
        Sha256Midstate(buf=b"abc", total=2)
    with pytest.raises(ValueError):
        Sha256Midstate(buf=b"abc", total=4 + 64 * 3 + 1)
    m = Sha256Midstate()
    m.update(b"abc" * 50)
    assert m.digest() == hashlib.sha256(b"abc" * 50).digest()
    assert Sha256Midstate(*m.export()).digest() == m.digest()


# ---------------------------------------------------------------------------
# one round's scalars against the JAX package's _round_scalars
# ---------------------------------------------------------------------------

_NEAR_55 = (1 << 55) - 12345  # a lane sum of 2^23 limbs just below its ceiling


def _lanes(case: str, rng):
    if case == "near 2^55":
        return [[_NEAR_55 - int(rng.integers(0, 1 << 20)) for _ in range(4)] for _ in range(2)]
    if case == "zero":
        return [[0] * 4, [0] * 4]
    return [[int(rng.integers(0, 1 << 55)) for _ in range(4)] for _ in range(2)]


@pytest.mark.parametrize("prefix", [0, 24, 60])
@pytest.mark.parametrize("case,prev", [("random", "random"), ("near 2^55", "random"), ("random", 0),
                                       ("near 2^55", P - 1), ("zero", P - 1)])
def test_round_scalars_match_jax(prefix, case, prev):
    """Lane sums up to 2^55 reduced mod p, the degree-2 interpolation, the
    absorbs of c1 and c2, r, r/2 and the next running sum; after a prefix
    of 0, 24 (the digest then needs two blocks) or 60 bytes (the absorb
    crosses a block)."""
    rng = np.random.default_rng(prefix + len(case) + (prev if isinstance(prev, int) else 7) % 97)
    prev_v = int.from_bytes(rng.bytes(16), "little") % P if prev == "random" else prev
    lanes = _lanes(case, rng)
    host, jhost = Transcript(), JTranscript()
    data = rng.bytes(prefix)
    host.absorb(data)
    jhost.absorb(data)

    state = dtr.state_from_host(host)
    scal = limbs.pack_ints([prev_v, 0, 0])
    coeffs, digest = torch.zeros((2, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    dtr.round_scalars(state, scal, digest, sums=torch.tensor(lanes, dtype=torch.int64), coeffs=coeffs)

    sums = [ops.limb_sums_to_int(row) for row in lanes]
    jsums = jnp.asarray(jlimbs.pack_ints(sums).reshape(8, 2))
    jtr, jr, jc1, jc2, jprev = _j_round_scalars(jsums, jnp.asarray(jlimbs.pack_scalar(JFp(prev_v))),
                                                jdt.state_from_host(jhost))
    assert _same_as_jax(state, jtr)
    got_prev, got_r, got_rh = (int(v) for v in limbs.unpack_ints(scal))
    c1, c2 = (int(v) for v in limbs.unpack_ints(coeffs))
    assert (c1, c2) == (jlimbs.unpack_int(np.asarray(jc1)), jlimbs.unpack_int(np.asarray(jc2)))
    assert got_r == jlimbs.unpack_int(np.asarray(jr))
    assert got_prev == jlimbs.unpack_int(np.asarray(jprev))
    assert got_rh == got_r * pow(2, -1, P) % P
    assert digest_to_bytes(digest.numpy()) == _jax_digest(jtr)


@pytest.mark.parametrize("prefix", [1, 31, 33, 59])
def test_round_scalars_with_a_root_and_the_last_element(prefix):
    """A round that absorbs the previous tree's root first, then the
    last-element launch, at unaligned fills: against the host transcript
    absorbing the same bytes."""
    rng = np.random.default_rng(prefix)
    host = Transcript()
    host.absorb(rng.bytes(prefix))
    state = dtr.state_from_host(host)
    root = torch.from_numpy(rng.integers(0, 2**32, size=8, dtype=np.uint32).view(np.int32))
    prev = int.from_bytes(rng.bytes(16), "little") % P
    scal = limbs.pack_ints([prev, 0, 0])
    coeffs, digest = torch.zeros((2, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    lanes = _lanes("random", rng)
    dtr.round_scalars(state, scal, digest, sums=torch.tensor(lanes, dtype=torch.int64), root=root, coeffs=coeffs)
    host.absorb(digest_to_bytes(root.numpy()))
    c1, c2 = limbs.unpack_fps(coeffs)
    host.absorb(c1.to_bytes())
    host.absorb(c2.to_bytes())
    assert limbs.unpack_fps(scal)[1] == host.next_challenge()
    assert digest_to_bytes(digest.numpy()) == host.random()
    s1, s2 = (ops.limb_sums_to_int(row) for row in lanes)
    s0 = (prev - s1) % P  # p(X) = s0 + c1 X + c2 X^2 through p(1) = s1, p(2) = s2
    assert (c1 + c2).v == (s1 - s0) % P and (c1 + c1 + c2 + c2 + c2 + c2).v == (s2 - s0) % P

    last = limbs.pack_ints([int.from_bytes(rng.bytes(16), "little") % P] * 2)
    before = scal.clone()
    dtr.round_scalars(state, scal, digest, elem=last)
    host.absorb(limbs.unpack_fps(last)[0].to_bytes())
    assert digest_to_bytes(digest.numpy()) == host.random() == dtr.digest(state)
    assert torch.equal(scal, before), "the last-element launch leaves the scalars alone"


@pytest.mark.parametrize("fill", [1, 2, 3, 61, 62, 63])
def test_round_scalars_straddle_a_block_at_every_word_offset(fill):
    """From a fill that is not a multiple of 4 (a whole block absorbed
    before): a round with a root (64 bytes: across a block's end from any of
    these fills), a round without one (32 bytes) and the last element (16
    bytes: across from 61-63), each against the JAX package's host
    transcript absorbing the same bytes - what the kernel's word-granular
    absorb must keep."""
    rng = np.random.default_rng(700 + fill)
    prior = rng.bytes(64 + fill)
    jhost = JTranscript()
    jhost.absorb(prior)
    host = Transcript()
    host.absorb(prior)
    state = dtr.state_from_host(host)
    assert int(state[24]) == fill
    prev = int.from_bytes(rng.bytes(16), "little") % P
    scal = limbs.pack_ints([prev, 0, 0])
    coeffs, digest = torch.zeros((2, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    absorbed = 64 + fill
    for root in (torch.from_numpy(rng.integers(0, 2**32, size=8, dtype=np.uint32).view(np.int32)), None):
        lanes = _lanes("random", rng)
        dtr.round_scalars(state, scal, digest, sums=torch.tensor(lanes, dtype=torch.int64), root=root,
                          coeffs=coeffs)
        if root is not None:
            jhost.absorb(digest_to_bytes(root.numpy()))
        s1, s2 = (ops.limb_sums_to_int(row) for row in lanes)
        s0 = (prev - s1) % P
        c2 = (s2 - 2 * s1 + s0) * pow(2, -1, P) % P
        c1 = (s1 - s0 - c2) % P
        jhost.absorb(JFp(c1).to_bytes())
        jhost.absorb(JFp(c2).to_bytes())
        r = jhost.next_challenge().v
        absorbed += 32 + (32 if root is not None else 0)
        assert [int(v) for v in limbs.unpack_ints(coeffs)] == [c1, c2]
        assert [int(v) for v in limbs.unpack_ints(scal)] == [(s0 + r * (c1 + r * c2)) % P, r,
                                                             r * pow(2, -1, P) % P]
        assert digest_to_bytes(digest.numpy()) == jhost.random()
        assert (int(state[24]), int(state[25])) == (absorbed % 64, absorbed)
        prev = (s0 + r * (c1 + r * c2)) % P
    last = limbs.pack_ints([int.from_bytes(rng.bytes(16), "little") % P] * 2)
    dtr.round_scalars(state, scal, digest, elem=last)
    jhost.absorb(limbs.unpack_fps(last)[0].to_bytes())
    assert digest_to_bytes(digest.numpy()) == jhost.random()
    assert dtr.state_to_host(state).random() == jhost.random()


def test_round_scalars_rejects_bad_arguments():
    state, scal = dtr.fresh_state(), limbs.pack_ints([0, 0, 0])
    digest, coeffs = torch.zeros(8, dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32)
    sums = torch.zeros((2, 4), dtype=torch.int64)
    last = limbs.pack_ints([1, 1])
    for call in (
        lambda: dtr.round_scalars(state, scal, digest),  # neither sums nor elem
        lambda: dtr.round_scalars(state, scal, digest, sums=sums, coeffs=coeffs, elem=last),
        lambda: dtr.round_scalars(state, scal, digest, sums=sums),  # no slot for the coefficients
        lambda: dtr.round_scalars(state, scal, digest, elem=last, root=digest),
        lambda: dtr.round_scalars(state, scal, digest, sums=sums.to(torch.int32), coeffs=coeffs),
        lambda: dtr.round_scalars(state[:25], scal, digest, elem=last),
        lambda: dtr.round_scalars(state, scal, digest, elem=last.t()),
        lambda: dtr.round_scalars(state.to("meta"), scal.to("meta"), digest.to("meta"), elem=last.to("meta")),
    ):
        with pytest.raises(ValueError):
            call()
