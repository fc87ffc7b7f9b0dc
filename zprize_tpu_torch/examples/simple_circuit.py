"""Example: build, prove and verify a small PLONK circuit on the port —
the counterpart of `examples/simple_circuit.py` (the reference's
`examples/simple_circuit.rs`).

Circuit: prove knowledge of a, b such that
  a + b = 25 (public), a * b = 100, a < 2^6, and e = k*J for the embedded
  curve generator J (fixed-base scalar mul), with e bound as a public point.

The key comes from the spec's `preprocess` on the host; the proof from
`prove_torch` through the kernels (or their plain versions on the CPU); the
copied spec verifier checks it.

Run: python3 -m zprize_tpu_torch.examples.simple_circuit [--device cpu]
"""

import argparse
import time

import torch

from ..params import R_MOD
from ..circuit import StandardComposer
from ..curve import jubjub
from ..device import resolve
from ..protocol import prover_torch as prover
from ..protocol.srs import device_srs, host_srs
from ..protocol.transcript_protocol import TranscriptProtocol
from ..ref import prover as rp
from ..ref.verifier import verify

TAU = 0xC0FFEE


def gadget(cs: StandardComposer):
    a = cs.add_input(20)
    b = cs.add_input(5)
    # a + b == 25 as a public input
    cs.arithmetic_gate(q_l=1, q_r=1, w_l=a, w_r=b, q_o=0, w_o=cs.zero_var,
                       pi=(-25) % R_MOD)
    # a * b == 100 (circuit constant)
    e = cs.mul(a, b)
    cs.constrain_to_constant(e, 100)
    # range check
    cs.range_gate(a, 6)
    # embedded-curve fixed-base mul
    k = 67 * 5
    kv = cs.add_input(k)
    pt = cs.fixed_base_scalar_mul(kv)
    expected = jubjub.mul(jubjub.GENERATOR, k)
    cs.constrain_to_constant(pt.x, 0, pi=(-expected[0]) % R_MOD)
    cs.constrain_to_constant(pt.y, 0, pi=(-expected[1]) % R_MOD)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None):
    """Build, prove and verify on `device` (CUDA unless "cpu"); returns
    {"gates", "n", "verify", "seconds"}."""
    dev = resolve(device)
    secs = {}
    cs = StandardComposer()
    gadget(cs)
    cs.check_circuit_satisfied()
    gates, n = cs.n, cs.circuit_bound()
    print(f"gates: {gates}, padded domain: {n}", flush=True)

    t0 = time.time()
    points, lite, _ = device_srs(n + 8, tau=TAU, device=dev)
    srs = host_srs(points, lite)
    secs["srs"] = time.time() - t0

    tr = TranscriptProtocol(b"simple_circuit")
    t0 = time.time()
    pk, vk = rp.preprocess(cs, srs, tr)
    secs["preprocess"] = time.time() - t0
    print(f"preprocess: {secs['preprocess']:.1f}s", flush=True)

    t0 = time.time()
    proof = prover.prove_torch(
        prover.ProverWitness.from_composer(cs, n, dev),
        prover.DevProverKey.from_ref(pk, dev),
        prover.DevSRS.from_ref(srs, dev), tr, prover.ProverConfig(device=dev))
    _sync(dev)
    secs["prove"] = time.time() - t0
    print(f"prove: {secs['prove']:.1f}s", flush=True)

    vtr = TranscriptProtocol(b"simple_circuit")
    rp.seed_transcript(vtr, vk)
    t0 = time.time()
    ok = bool(verify(vk, srs, proof, cs.public_inputs, vtr))
    secs["verify"] = time.time() - t0
    print(f"verify: {ok} ({secs['verify']:.1f}s)", flush=True)
    if not ok:
        raise AssertionError("the simple circuit's proof does not verify")
    return {"gates": gates, "n": n, "verify": ok, "seconds": secs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
