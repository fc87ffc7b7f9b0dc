"""Device preprocessing for the Merkle layout — the port of
`zprize_tpu/merkle/preprocess.py`: selector/sigma INTTs and KZG commits
straight from the tiled layout tensors (`preprocess.rs:162-492`
counterpart). The prover key is coefficient-only; the quotient round
recomputes sub-coset evaluations on the fly.

Each phase ends in a sync that pulls ONE element to the host, so a device
fault is attributed to its phase; `log` (if given) receives one line per
phase with its seconds. The layout's tiled selector columns are released
at the end (`MerkleLayout.release_selector_limbs`)."""

import time

import torch

from ..protocol.prover_torch import DevProverKey, ProverConfig, commit_batch
from ..ref.prover import VerifierKey, SELECTOR_ORDER, SIGMA_NAMES, \
    seed_transcript
from ..ops import ntt as tntt
from ..fields.mont import FR
from .layout import MerkleLayout


def _sync(label, arr, t0, log):
    arr.reshape(-1)[:1].cpu()
    now = time.time()
    if log:
        log(f"preprocess {label}: {now - t0:.3f}s")
    return now


def preprocess_layout(lay: MerkleLayout, dev_srs, transcript,
                      cfg: ProverConfig = None, log=None):
    """Returns (DevProverKey, VerifierKey); seeds the transcript."""
    cfg = cfg or ProverConfig(device=lay.device)
    n = lay.n
    log_n = n.bit_length() - 1
    plan = tntt.get_plan(log_n, cfg.device)

    pk = DevProverKey()
    pk.n = n
    pk.log_n = log_n

    t0 = time.time()
    sel_polys = []
    for s in range(0, len(SELECTOR_ORDER), 5):
        names = SELECTOR_ORDER[s:s + 5]
        out = tntt.intt(plan, torch.stack(
            [lay.selector_limbs[name] for name in names], dim=1))
        sel_polys.extend(out[:, i].contiguous() for i in range(len(names)))
        t0 = _sync(f"selector intt [{s}:{s + len(names)}]", out, t0, log)
        del out
    pk.sel_poly = dict(zip(SELECTOR_ORDER, sel_polys))

    sigma_evals = lay.sigma_evals_device()
    t0 = _sync("sigma evals", sigma_evals[0], t0, log)
    pk.sigma_evals_n = sigma_evals
    sigma_polys = tntt.intt(plan, torch.stack(sigma_evals, dim=1))
    pk.sigma_poly = [sigma_polys[:, i].contiguous() for i in range(4)]
    t0 = _sync("sigma intt", sigma_polys, t0, log)
    del sigma_polys

    all_polys = sel_polys + pk.sigma_poly
    comms = []
    for s in range(0, len(all_polys), 4):
        group = all_polys[s:s + 4]
        comms.extend(commit_batch(dev_srs, torch.stack(group, dim=1), cfg))
        now = time.time()
        if log:
            log(f"preprocess commit [{s}:{s + len(group)}]: {now - t0:.3f}s")
        t0 = now
    commitments = dict(zip(SELECTOR_ORDER + SIGMA_NAMES, comms))

    # empty lookup table -> 4 all-zero padded columns; q_lookup is
    # identically zero in this circuit, so the lookup is degenerate
    zero_col = torch.zeros((FR.L, n), dtype=torch.int32, device=cfg.device)
    pk.table_cols = [zero_col] * 4
    pk.lookup_degenerate = not bool(lay.selector_limbs["q_lookup"].any())
    # the key holds the selectors' polynomials now: the 4 GB of tiled
    # columns at height 15 need not stay (the prover and prove_many's
    # replicas read the key, not the layout)
    lay.release_selector_limbs()
    vk = VerifierKey(n, commitments, [None] * 4)
    seed_transcript(transcript, vk)
    return pk, vk
