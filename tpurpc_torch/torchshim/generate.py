"""Step-function decode models: the contract the decode scheduler drives.

The port of ``tpurpc/jaxshim/generate.py``. Two contracts, as there:

* opaque state — ``prefill(prompts) -> (states, first_tokens)`` and
  ``step(states, tokens) -> (states, tokens)``: ``states`` carries a
  leading batch axis (row ``i`` is sequence ``i``), tokens are ``int32[B]``
  numpy arrays on the host (they have to reach the host to stream);
* explicit KV — ``prefill_paged(prompts, kvs) -> first_tokens`` and
  ``step_paged(kvs, tokens) -> tokens`` over block tables of 16-byte
  ``(hash, token, flags)`` entries (:mod:`tpurpc_torch.serving.kv`).

Rows are independent, so the scheduler may re-batch them between calls and
retry a failed call row by row.

:class:`ToyDecodeModel` implements both with its state on a device: the
opaque state is an int64 ``[B, 3]`` tensor (hash, last token, poisoned) on
``device`` that never leaves it, and one call advances the whole batch in
a few launches, then brings the tokens (and the poisoned column) to the
host in ONE copy. The hash is the reference's affine 64-bit fold, done in
int64, whose ``*`` and ``+`` wrap mod 2^64 with the same bits as uint64:
after ``>> 16`` (which copies the sign bit) the result is masked to 48
bits before ``% vocab``. A prompt folds in one product and one sum per row
(``h = sum (INC + t_j) * MULT^(L-1-j)``, powers precomputed, wrapped); the
paged prefill needs every prefix hash, which one ``cumsum`` gives, because
MULT is odd and so has an inverse mod 2^64:
``h_k = MULT^k * (MULT * seed + sum_{j<=k} (INC + t_j) * MULT^-j)``.
The paged contract's entries stay in the host arena, as in the reference:
a step gathers the rows' last hashes into one int64 tensor, advances them
on the device and brings tokens and hashes back in one copy.

:func:`reference_decode` recomputes any prompt's exact token stream with
Python integers: the out-of-band truth the tests compare against.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpurpc_torch.utils.config import resolve_device

__all__ = ["ToyDecodeModel", "reference_decode"]

#: state layout of the toy model: [hash, last_token, poisoned]
_STATE_DIM = 3
#: multiplier/increment of the affine hash (the reference's)
_MULT = 1103515245
_INC = 12345
_MASK64 = (1 << 64) - 1
_MASK48 = (1 << 48) - 1
_MULT_INV = pow(_MULT, -1, 1 << 64)


def _signed(u: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    u &= _MASK64
    return u - (1 << 64) if u >> 63 else u


def _powers(base: int, n: int) -> np.ndarray:
    """``base**i mod 2**64`` for i in [0, n), as int64 bits."""
    out = np.empty(n, dtype=np.int64)
    acc = 1
    for i in range(n):
        out[i] = _signed(acc)
        acc = (acc * base) & _MASK64
    return out


class ToyDecodeModel:
    """Deterministic autoregressive stand-in implementing both step-model
    contracts with its state on ``device`` (default: the config's device,
    ``cuda`` unless ``TPURPC_TORCH_DEVICE`` says otherwise).

    Failure knobs, as in the reference: ``poison_token`` marks a prompt's
    row poisoned (prefill succeeds; any step whose batch holds a poisoned
    row raises, a single-row step of a clean row succeeds), and
    ``step_delay_s`` sleeps inside every step.
    """

    def __init__(self, vocab: int = 251, eos: Optional[int] = None,
                 poison_token: Optional[int] = None,
                 step_delay_s: float = 0.0, device=None):
        if vocab < 2:
            raise ValueError("vocab must be >= 2")
        self.vocab = int(vocab)
        self.eos = eos
        self.poison_token = poison_token
        self.step_delay_s = float(step_delay_s)
        self.device = resolve_device(device)
        self.prefills = 0
        self.steps = 0
        #: (MULT**i, MULT**-i) on the device, replaced whole when grown
        self._pow_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # -- device constants ---------------------------------------------------

    def _tables(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``MULT**i`` and ``MULT**-i`` (wrapped) for i < at least n, on
        the device; grown by doubling. A server calls the model from many
        handler threads, so the pair is read and replaced as one value."""
        tables = self._pow_tables
        if tables is None or tables[0].numel() < n:
            size = max(64, 1 << max(0, n - 1).bit_length())
            tables = tuple(torch.from_numpy(_powers(base, size)).to(
                self.device) for base in (_MULT, _MULT_INV))
            self._pow_tables = tables
        return tables

    def _sample(self, h: torch.Tensor) -> torch.Tensor:
        """The token of hash ``h``: ``(h >> 16) % vocab`` on uint64 bits."""
        return ((h >> 16) & _MASK48) % self.vocab

    def _prompt_rows(self, prompts) -> List[np.ndarray]:
        rows = []
        for p in prompts:
            p = np.asarray(p, dtype=np.int64).reshape(-1)
            if p.size == 0:
                raise ValueError("empty prompt")
            rows.append(p)
        return rows

    def _poisoned(self, p: np.ndarray) -> bool:
        return (self.poison_token is not None
                and bool(np.any(p == self.poison_token)))

    # -- the opaque-state contract -------------------------------------------

    def prefill(self, prompts: Sequence) -> Tuple[torch.Tensor, np.ndarray]:
        self.prefills += 1
        rows = self._prompt_rows(prompts)
        n = max(p.size for p in rows)
        # one upload: each prompt's terms right-aligned (a zero term adds
        # nothing), then the row's poisoned flag
        host = np.zeros((len(rows), n + 1), dtype=np.int64)
        for i, p in enumerate(rows):
            host[i, n - p.size:n] = p + _INC
            host[i, n] = 1 if self._poisoned(p) else 0
        x = torch.from_numpy(host).to(self.device)
        pw, _ = self._tables(n)
        h = (x[:, :n] * pw[:n].flip(0)).sum(dim=1)
        states = torch.stack([h, torch.zeros_like(h), x[:, n]], dim=1)
        states, out = self._advance(states)
        return states, out[:, 0].astype(np.int32)

    def step(self, states, tokens) -> Tuple[torch.Tensor, np.ndarray]:
        self.steps += 1
        states = torch.as_tensor(states, device=self.device)
        if states.dim() != 2 or states.shape[1] != _STATE_DIM:
            raise ValueError(f"bad state shape {tuple(states.shape)}")
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        states, out = self._advance(states)
        # the poisoned column came back in the tokens' copy: no second sync
        if out[:, 1].any():
            raise ValueError("poisoned row in decode batch")
        return states, out[:, 0].astype(np.int32)

    def _advance(self, states: torch.Tensor
                 ) -> Tuple[torch.Tensor, np.ndarray]:
        """One affine step of every row on the device; returns the new
        states and, in one device-to-host copy, ``[token, poisoned]`` per
        row."""
        h = states[:, 0] * _MULT + _INC          # wraps mod 2^64
        tok = self._sample(h)
        new = torch.stack([h, tok, states[:, 2]], dim=1)
        return new, new[:, 1:].cpu().numpy()

    # -- the explicit-KV contract ----------------------------------------------

    def prefill_paged(self, prompts: Sequence, kvs: Sequence) -> np.ndarray:
        """Fold each prompt's uncached tail into its block table: row ``i``
        starts from the ``kvs[i].length`` entries already present (the last
        one seeds the hash), appends one entry per remaining prompt token,
        then the first sampled token's. Returns ``int32[B]`` first tokens,
        value-identical to :meth:`prefill`."""
        self.prefills += 1
        rows = self._prompt_rows(prompts)
        seeds, tails = [], []
        for p, kv in zip(rows, kvs):
            start = kv.length
            if start > p.size:
                raise ValueError(f"table holds {start} entries for a "
                                 f"{p.size}-token prompt")
            h, _tok, flags = kv.entry(start - 1) if start else (0, 0, 0)
            seeds.append((h, flags))
            tails.append(p[start:])
        n = max(1, max(t.size for t in tails))
        # one upload per batch: [seed, tail length, INC + t_0 ...]
        host = np.zeros((len(rows), n + 2), dtype=np.int64)
        for i, ((h, _f), t) in enumerate(zip(seeds, tails)):
            host[i, 0] = _signed(h)
            host[i, 1] = t.size
            host[i, 2:2 + t.size] = t + _INC
        x = torch.from_numpy(host).to(self.device)
        pw, ipw = self._tables(n + 1)
        seed, lens, c = x[:, 0], x[:, 1], x[:, 2:]
        acc = torch.cumsum(c * ipw[:n], dim=1) + (seed * _MULT)[:, None]
        hs = torch.cat([seed[:, None], acc * pw[:n]], dim=1)  # h_{-1}..
        h_last = hs.gather(1, lens[:, None])[:, 0]
        h_first = h_last * _MULT + _INC
        first = self._sample(h_first)
        out = torch.cat([hs[:, 1:], h_first[:, None], first[:, None]],
                        dim=1).cpu().numpy()
        hashes = out.view(np.uint64)
        toks = np.empty(len(rows), dtype=np.int32)
        for i, (kv, (_h, flags), t) in enumerate(zip(kvs, seeds, tails)):
            row = hashes[i].tolist()
            for k, tk in enumerate(t.tolist()):
                if self.poison_token is not None \
                        and tk == self.poison_token:
                    flags |= 1  # FLAG_POISONED: latent, trips at step
                kv.append(row[k], tk, flags)
            tok = int(out[i, n + 1])
            kv.append(row[n], tok, flags)
            toks[i] = tok
        return toks

    def step_paged(self, kvs: Sequence, tokens) -> np.ndarray:
        """One paged decode step for the whole batch: the rows' last
        hashes go to the device as one int64 tensor, advance there, and
        come back with their tokens in one copy; each row appends its
        entry. Any poisoned row fails the whole call."""
        self.steps += 1
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        lasts = [kv.last() for kv in kvs]
        if any(flags & 1 for _h, _t, flags in lasts):
            raise ValueError("poisoned row in decode batch")
        hs = np.array([h for h, _t, _f in lasts], dtype=np.uint64)
        h = torch.from_numpy(hs.view(np.int64)).to(self.device)
        h = h * _MULT + _INC
        out = torch.stack([h, self._sample(h)], dim=1).cpu().numpy()
        new_h = out[:, 0].view(np.uint64).tolist()
        toks = out[:, 1].astype(np.int32)
        for kv, hn, tok, (_h, _t, flags) in zip(kvs, new_h, toks.tolist(),
                                                 lasts):
            kv.append(hn, tok, flags)
        return toks


def reference_decode(prompt, n_tokens: int, vocab: int = 251,
                     eos: Optional[int] = None) -> List[int]:
    """The exact token stream :class:`ToyDecodeModel` emits for ``prompt``
    (including the prefill's first token), computed with Python integers
    and no model. Stops early at ``eos`` (inclusive) when given."""
    h = 0
    for t in np.asarray(prompt, dtype=np.int64).reshape(-1).tolist():
        h = (h * _MULT + _INC + int(t)) & _MASK64
    out: List[int] = []
    for _ in range(n_tokens):
        h = (h * _MULT + _INC) & _MASK64
        tok = (h >> 16) % vocab
        out.append(int(tok))
        if eos is not None and tok == eos:
            break
    return out
