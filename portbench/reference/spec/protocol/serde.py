"""arkworks-CanonicalSerialize-compatible Proof encoding.

Field order follows ZK-Garage's `Proof` struct
(`plonk-core/src/proof_system/proof.rs:51-118`) with derive(CanonicalSerialize)
semantics: 19 compressed G1 commitments, two KZG opening proofs
(`ark_poly_commit::kzg10::Proof { w: G1, random_v: Option<Fr> }`), then
`ProofEvaluations` (wire/perm/lookup evals as 32-byte LE scalars, then
`Vec<(String, F)>` custom evals with u64 lengths).

This is the cross-implementation fixture format: a Rust harness holding the
same verifier key can deserialize and verify these bytes directly.
"""

import struct

from ..transcript.serialize import serialize_fr, serialize_g1
from .proof import Proof, Evaluations


def _ser_option_fr(v):
    if v is None:
        return b"\x00"
    return b"\x01" + serialize_fr(v)


def _ser_opening(w_point):
    # kzg10::Proof { w, random_v: None } — hiding disabled, like the
    # reference (SURVEY.md §5 note 3)
    return serialize_g1(w_point) + _ser_option_fr(None)


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def serialize_proof(proof: Proof) -> bytes:
    out = bytearray()
    for c in (proof.a_comm, proof.b_comm, proof.c_comm, proof.d_comm,
              proof.z_comm, proof.f_comm, proof.h_1_comm, proof.h_2_comm,
              proof.z_2_comm, *proof.t_comms):
        out += serialize_g1(c)
    out += _ser_opening(proof.aw_opening)
    out += _ser_opening(proof.saw_opening)
    ev = proof.evaluations
    for v in (ev.a_eval, ev.b_eval, ev.c_eval, ev.d_eval,
              ev.left_sigma_eval, ev.right_sigma_eval, ev.out_sigma_eval,
              ev.permutation_eval,
              ev.q_lookup_eval, ev.z2_next_eval, ev.h1_eval,
              ev.h1_next_eval, ev.h2_eval, ev.f_eval, ev.table_eval,
              ev.table_next_eval):
        out += serialize_fr(v)
    out += struct.pack("<Q", len(ev.custom_evals))
    for label, v in ev.custom_evals:
        out += _ser_string(label)
        out += serialize_fr(v)
    return bytes(out)


def _deser_fq(buf, off):
    from ..params import Q_MOD
    raw = bytearray(buf[off:off + 48])
    flags = raw[47] & 0xC0
    raw[47] &= 0x3F
    x = int.from_bytes(raw, "little")
    return x, flags, off + 48


def deserialize_g1(buf, off):
    """Decompress an arkworks G1 point; returns (point|None, new offset)."""
    from ..params import Q_MOD
    x, flags, off = _deser_fq(buf, off)
    if flags & 0x40:
        return None, off
    # y^2 = x^3 + 4
    y2 = (pow(x, 3, Q_MOD) + 4) % Q_MOD
    y = pow(y2, (Q_MOD + 1) // 4, Q_MOD)
    if y * y % Q_MOD != y2:
        raise ValueError("x not on curve")
    is_positive = bool(flags & 0x80)
    if (y > Q_MOD - y) != is_positive:
        y = Q_MOD - y
    return (x, y), off


def _deser_fr(buf, off):
    return int.from_bytes(buf[off:off + 32], "little"), off + 32


def deserialize_proof(buf: bytes) -> Proof:
    off = 0
    comms = []
    for _ in range(17):
        c, off = deserialize_g1(buf, off)
        comms.append(c)
    aw, off = deserialize_g1(buf, off)
    assert buf[off] == 0, "hiding openings unsupported"
    off += 1
    saw, off = deserialize_g1(buf, off)
    assert buf[off] == 0
    off += 1
    vals = []
    for _ in range(16):
        v, off = _deser_fr(buf, off)
        vals.append(v)
    (n_custom,) = struct.unpack_from("<Q", buf, off)
    off += 8
    custom = []
    for _ in range(n_custom):
        (slen,) = struct.unpack_from("<Q", buf, off)
        off += 8
        label = buf[off:off + slen].decode()
        off += slen
        v, off = _deser_fr(buf, off)
        custom.append((label, v))
    assert off == len(buf), "trailing bytes"
    ev = Evaluations(
        a_eval=vals[0], b_eval=vals[1], c_eval=vals[2], d_eval=vals[3],
        left_sigma_eval=vals[4], right_sigma_eval=vals[5],
        out_sigma_eval=vals[6], permutation_eval=vals[7],
        q_lookup_eval=vals[8], z2_next_eval=vals[9], h1_eval=vals[10],
        h1_next_eval=vals[11], h2_eval=vals[12], f_eval=vals[13],
        table_eval=vals[14], table_next_eval=vals[15], custom_evals=custom)
    return Proof(
        a_comm=comms[0], b_comm=comms[1], c_comm=comms[2], d_comm=comms[3],
        z_comm=comms[4], f_comm=comms[5], h_1_comm=comms[6],
        h_2_comm=comms[7], z_2_comm=comms[8], t_comms=comms[9:17],
        aw_opening=aw, saw_opening=saw, evaluations=ev)
