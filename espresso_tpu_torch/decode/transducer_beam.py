"""Batched transducer beam search: Adaptive Expansion Search (AES).

Counterpart of ``espresso_tpu/decode/transducer_beam.py`` (:157-1344) in its
fused structure, the one the JAX decoder runs on its TPU (``use_fused``,
``use_pred_kernel`` and ``use_lm_kernel``): per encoder frame, every
utterance and hypothesis advances in lockstep through
``max_num_expansions_per_step`` label rounds, each scored by the joint
kernel ``fused_joint_topk`` and followed by a blank merge (``aes_merge``);
candidates are pruned by value (``gamma`` below the round's best) and count
(beam + ``beta``); the prediction net advances through ``lstm_step_reorder``
on one packed state matrix. At each frame start the proper-prefix merge
folds a prefix hypothesis' mass into its extensions (depth <=
``prefix_alpha``, found by inverting the rolling hash). Token sequences are
not carried: each frame emits backpointers, and ``aes_backtrace`` walks them
in reverse once per batch.

LSTM-LM shallow fusion (``lm``, ``lm_weight``): the LM starts from eos, with
the blank-less index shift (LM index = model index - 1), and each row keeps
the f32 log-softmax of its LM logits. Each round the joint kernel adds them,
shifted and scaled by ``lm_weight``, as a label bias and returns each row's
renormalisation factor (the non-blank mass is kept); the prefix merge adds
the same LM terms (depth >= 2 through a ring of the last A - 1 cached LM
rows). After each round the LM advances by ``lstm_step_reorder`` on its own
packed state, gate-padded by ``prep_lstm_kernel_inputs``; its head (the
additional projection, the output layer or the tied embedding) stays
``torch.matmul``. A prediction net whose embedding width differs from its
hidden width runs through the same padding.

The decoder always calls the four kernel wrappers, so on the CPU their plain
versions carry it and on the card the kernels do. The JAX jnp structure
(``fused_kernel="off"``) is not ported, nor JAX's row-major big-LM path
(``_prep_big_lm``), which exists for the TPU's VMEM: the kernel runs every
LSTM LM. The frame loop is a Python loop over encoder frames with the
rounds unrolled inside; nothing in it waits for the host, so a later CUDA
graph can capture it. Not ported: ``max_num_expansions_per_step=0`` and LMs
other than the LSTM LM (both raise).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel
from espresso_tpu_torch.ops.decode_kernels import (
    LN_EPS,
    NEG_INF,
    aes_backtrace,
    aes_merge,
    fused_joint_topk,
    lstm_feat,
    lstm_step_reorder,
    pack_lstm_state,
    prep_lstm_kernel_inputs,
    rows_topk,
)

# multiplicative inverse of the rolling-hash base 31 mod 2^32:
# parent_hash = (hash - (tok + 1)) * INV31 in int32 arithmetic
INV31 = -1108378657


def hash_push(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Rolling sequence hash after emitting ``tok``: h * 31 + tok + 1, taken
    in int64 and cast to int32, which keeps the low 32 bits: JAX's int32
    wrap."""
    return (h.long() * 31 + tok.long() + 1).to(torch.int32)


def hash_pop(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hash_push`: (h - tok - 1) * INV31, wrapped alike."""
    return ((h.long() - tok.long() - 1) * INV31).to(torch.int32)


def lm_label_bias(lp: torch.Tensor, V: int, lm_weight: float) -> torch.Tensor:
    """[BK, V] label bias of the joint kernel (transducer_beam.py:386-400):
    the cached LM log-probs [BK, V_lm] shifted right by one (LM index =
    model index - 1, the blank-less shift), NEG_INF at the blank and past the
    LM's vocab, times ``lm_weight``."""
    width = min(V - 1, lp.shape[-1])
    shifted = torch.full((lp.shape[0], V), NEG_INF, dtype=torch.float32, device=lp.device)
    shifted[:, 1 : 1 + width] = lp[:, :width]
    return lm_weight * shifted.clamp(min=NEG_INF)


class TransducerBeamSearchDecoder:
    def __init__(
        self,
        model,
        dictionary,
        beam_size: int = 10,
        expansion_beta: int = 2,
        expansion_gamma: Optional[float] = 2.3,
        max_num_expansions_per_step: int = 2,
        max_out_factor: float = 0.35,
        lm=None,
        lm_weight: float = 0.0,
        model_predicts_eos: bool = False,
        prefix_alpha: Optional[int] = 1,
    ):
        """``lm``: an ``LSTMLanguageModel`` for shallow fusion, weighted by
        ``lm_weight`` (at 0 the LM is not run: its terms vanish). JAX
        weights load into it beforehand with ``bridge.load_jax_variables``."""
        if lm is not None and not isinstance(lm, LSTMLanguageModel):
            raise TypeError(
                f"LM fusion takes an LSTMLanguageModel, got {type(lm).__name__}: the adapters of "
                "the Transformer LM and the speech decoders are not ported (ROADMAP queue A)"
            )
        if max_num_expansions_per_step < 1:
            raise NotImplementedError("max_num_expansions_per_step=0 is not ported")
        # None is the reference's uncapped depth, which fixed shapes cannot
        # express: the advised depth 1 (transducer_beam.py:187-198)
        if prefix_alpha is None:
            prefix_alpha = 1
        if prefix_alpha < 0:
            raise ValueError(f"prefix_alpha must be >= 0, got {prefix_alpha}")
        self.model = model
        self.dict = dictionary
        self.blank = dictionary.blank()
        self.eos = dictionary.eos()
        self.model_predicts_eos = model_predicts_eos
        self.beam = beam_size
        self.expansion_beta = expansion_beta
        self.expansion_gamma = expansion_gamma
        self.n_exp = max_num_expansions_per_step
        self.max_out_factor = max_out_factor
        self.prefix_alpha = prefix_alpha
        # kernel-layout weights, once per decoder (the LSTM stacks are copies)
        self.joint_w, self.pred_w = model.beam_kernel_weights()
        self.lm, self.lm_weight, self.lm_w = lm, lm_weight, None
        if lm is not None and lm_weight != 0.0:
            dec = lm.decoder
            with torch.no_grad():
                self.lm_w = prep_lstm_kernel_inputs(
                    dec.embed_tokens.weight, [m.weight.t() for m in dec.cells_ih],
                    [m.bias for m in dec.cells_ih], [m.weight.t() for m in dec.cells_hh],
                )

    # ------------------------------------------------------------------
    def _lm_start(self, BK: int, dev):
        """The LM state after eos (LM index eos - 1), stepped as JAX steps
        it (transducer_beam.py:426-465): the packed gate-padded
        state [BK, 2 L Hp], the f32 log-softmax of its logits [BK, V_lm],
        and for prefix_alpha >= 2 an empty ring of the last A - 1 cached
        rows."""
        eos_lm = torch.full((BK,), self.eos - 1, dtype=torch.long, device=dev)
        logits, (h, c) = self.lm.decode_step(eos_lm, self.lm.init_carry(BK))
        pad = self.lm_w["Hp"] - self.lm_w["H"]
        S = pack_lstm_state(F.pad(h, (0, pad)), F.pad(c, (0, pad)))
        lp = torch.log_softmax(logits.float(), -1)
        A = self.prefix_alpha
        ring = lp.new_zeros((A - 1,) + lp.shape) if A >= 2 else None
        return S, lp, ring

    def _prefix_merge(self, enc_t, exp_feat, exp_scores, exp_hash, ints, fh, blank_lp,
                      lm=None, lm_factor=None):
        """Proper-prefix merge at the frame start (transducer_beam.py:615-781,
        the fused branch): returns the merged scores. The joint kernel keeps
        no [BK, V] log-probs, so each row's normaliser comes back from its
        blank log-prob: lse = logit_blank - blank_lp. Under LM fusion
        (``lm`` the rows' (state, cached log-probs, ring), ``lm_factor`` the
        joint kernel's per-row factor) each extension token adds its
        weighted LM log-prob and its source row's factor (:728-780); at
        depth >= 2 the token m emissions ago takes the ring's LM row and its
        own factor (:476-490, :693-725)."""
        B, K = exp_scores.shape
        A, blank, eos, jw = self.prefix_alpha, self.blank, self.eos, self.joint_w
        lw = self.lm_weight
        sl2 = ints[:, 1].reshape(B, K)
        th3 = ints[:, 2:].reshape(B, K, A)
        live2 = exp_scores > NEG_INF / 2
        d = exp_feat.float() @ jw["w_dec"].float() + jw["b_dec"]
        mu = d.mean(-1, keepdim=True)
        var = ((d - mu) ** 2).mean(-1, keepdim=True)
        dn = (d - mu) * torch.rsqrt(var + LN_EPS) * jw["ln_scale"] + jw["ln_bias"]
        hj = torch.relu(enc_t.float() + dn)
        w_out, b_out = jw["w_out"].float(), jw["b_out"]
        lb = hj @ w_out[:, blank] + b_out[blank]
        if self.model_predicts_eos:
            lb = torch.logaddexp(lb, hj @ w_out[:, eos] + b_out[eos])
        lse2 = (lb - blank_lp.reshape(-1)).reshape(B, K)
        h3 = hj.reshape(B, K, -1)

        def row_tok_lp(src, tok):
            hsrc = h3.gather(1, src[..., None].expand(-1, -1, h3.shape[-1]))
            tok = tok.long()
            logit = (hsrc * w_out.t()[tok]).sum(-1) + b_out[tok]
            return logit - lse2.gather(1, src)

        if A >= 2:
            # the token m emissions ago, scored by the feature of that time
            logits_h = self.model.joint_step_precomputed(
                enc_t.repeat(A - 1, 1), fh.reshape((A - 1) * B * K, -1)
            )
            lp_h = torch.log_softmax(logits_h.float(), -1).reshape(A - 1, B, K, -1)
            toks_h = th3[:, :, : A - 1].permute(2, 0, 1).long()
            term_h = lp_h.gather(3, toks_h[..., None])[..., 0]
            if lm is not None:
                # its LM log-prob under the cached row of that time, and
                # that row's renormalisation factor
                lmh3 = lm[2].reshape(A - 1, B, K, -1)
                wdt = min(lp_h.shape[-1] - 1, lmh3.shape[-1])
                lm_tok_h = lmh3.gather(3, (toks_h - 1).clamp(min=0)[..., None])[..., 0]
                lab_h = lp_h.clone()
                lab_h[..., blank] = NEG_INF
                shifted_h = torch.full_like(lp_h, NEG_INF)
                shifted_h[..., 1 : 1 + wdt] = lmh3[..., :wdt]
                fused_h = lab_h + lw * shifted_h.clamp(min=NEG_INF)
                fac_h = torch.logsumexp(lab_h, -1) - torch.logsumexp(fused_h, -1)
                term_h = term_h + lw * lm_tok_h + fac_h
            cum_h = torch.cumsum(term_h, 0)
        if lm is not None:
            lp_rows = lm[1].reshape(B, -1)  # [B, K V_lm]
            V_lm = lm[1].shape[-1]
        mass = torch.full_like(exp_scores, NEG_INF)
        anc = exp_hash
        for depth in range(1, A + 1):
            anc = hash_pop(anc, th3[:, :, depth - 1])
            # eq[b, i, j]: hypothesis i is the depth-d prefix of j
            eq = (
                (exp_hash[:, :, None] == anc[:, None, :])
                & (sl2[:, :, None] == sl2[:, None, :] - depth)
                & live2[:, :, None]
                & live2[:, None, :]
                & (sl2[:, None, :] >= depth)
            )
            has = eq.any(1)
            src = eq.to(torch.int32).argmax(1)  # the first prefix row
            tok0 = th3[:, :, depth - 1]
            contrib = exp_scores.gather(1, src) + row_tok_lp(src, tok0)
            if depth >= 2:
                contrib = contrib + cum_h[depth - 2]
            if lm is not None:
                lm_tok = (tok0.long() - 1).clamp(min=0)
                contrib = (
                    contrib + lw * lp_rows.gather(1, src * V_lm + lm_tok) + lm_factor.gather(1, src)
                )
            mass = torch.logaddexp(mass, torch.where(has, contrib, NEG_INF))
        return torch.logaddexp(exp_scores, mass)

    @torch.no_grad()
    def _run(self, src_frames: torch.Tensor, src_lengths: torch.Tensor, L_max: int):
        model, K, A, n_exp = self.model, self.beam, self.prefix_alpha, self.n_exp
        blank, jw, pw, lw = self.blank, self.joint_w, self.pred_w, self.lm_w
        gamma = self.expansion_gamma
        n_cand = K + self.expansion_beta
        B, dev = src_frames.shape[0], src_frames.device
        BK = B * K
        V = jw["w_out"].shape[1]
        L, Hpred = pw["w_ih"].shape[0], pw["H"]
        i32 = torch.int32

        enc = model.encode(src_frames, src_lengths)
        pdtype = next(model.parameters()).dtype
        carry = model.init_pred_carry(BK, pdtype, dev)
        _, (h0, c0) = model.pred_step(torch.full((BK,), blank, dtype=torch.long, device=dev), carry)
        # [BK, 2 L Hp], gate-padded past H; the feature is its top h
        pad = pw["Hp"] - Hpred
        S = pack_lstm_state(F.pad(h0, (0, pad)), F.pad(c0, (0, pad)))

        def feature(S_):
            return lstm_feat(S_, L)[:, :Hpred]

        # under LM fusion each row's (packed LM state, cached f32 log-probs,
        # ring of the last A - 1 cached rows)
        lm = self._lm_start(BK, dev) if lw is not None else None
        L_lm = None if lw is None else lw["w_ih"].shape[0]
        kcols = torch.arange(K, device=dev)
        scores = torch.where(kcols == 0, 0.0, NEG_INF).expand(B, K).contiguous()
        # packed int bookkeeping per row: the rolling hash, and under the
        # prefix merge the emitted-label count and the last A tokens (newest
        # first); for depth >= 2 a ring of the last A-1 features
        ints = torch.zeros((BK, 1 + (1 + A if A >= 1 else 0)), dtype=i32, device=dev)
        fh = torch.zeros((A - 1, BK, Hpred), dtype=pdtype, device=dev) if A >= 2 else None
        enc_proj = model.joint_enc_proj(enc.encoder_out)  # [B, T', J]
        T_enc, J = enc_proj.shape[1], enc_proj.shape[2]
        row_base = torch.arange(B, device=dev)[:, None] * K
        slot0 = kcols.to(i32).expand(B, K).contiguous()
        bps: List[tuple] = []

        for t in range(T_enc):
            enc_t = enc_proj[:, t, None].expand(B, K, J).reshape(BK, J)
            keep_old = ~(t < enc.src_lengths)  # inactive utterances keep their beam
            pool_scores = torch.full((B, K), NEG_INF, device=dev)
            pool_hash = ints[:, 0].reshape(B, K).contiguous()
            pool_ver = torch.zeros((B, K), dtype=i32, device=dev)
            pool_slot = slot0
            exp_scores, exp_hash, exp_S, exp_ints, exp_fh = scores, pool_hash, S, ints, fh
            exp_lm = lm
            exp_feat = feature(exp_S)
            # version v = the expansion state after v label rounds
            versions = [(exp_S, exp_ints, exp_fh, exp_lm)]
            fp_l, msrc_l, esrc_l, etok_l = [], [], [], []
            for j in range(n_exp + 1):
                bias = None if exp_lm is None else lm_label_bias(exp_lm[1], V, self.lm_weight)
                blank_lp, row_vals, row_flat, *factor = fused_joint_topk(
                    enc_t, exp_feat, exp_scores, **jw, K=K, n_cand=n_cand, blank=blank,
                    eos=self.eos, fold_eos_into_blank=self.model_predicts_eos, label_bias=bias,
                )
                if j == 0 and A >= 1:
                    merged = self._prefix_merge(
                        enc_t, exp_feat, exp_scores, exp_hash, exp_ints, exp_fh, blank_lp,
                        exp_lm, factor[0] if factor else None,
                    )
                    # a row's candidate set does not depend on its score:
                    # shift the row values by the merge's delta
                    delta = torch.where(exp_scores > NEG_INF / 2, merged - exp_scores, 0.0)
                    row_vals = row_vals + delta[..., None]
                    exp_scores = merged
                pool_scores, pool_hash, pool_ver, pool_slot, fp_i, src_slot = aes_merge(
                    pool_scores, exp_scores.contiguous(), pool_hash, exp_hash,
                    pool_ver, pool_slot, j, blank_lp=blank_lp,
                )
                fp_l.append(fp_i)
                msrc_l.append(src_slot)
                if j == n_exp:
                    break
                # label expansion: top K+beta, gamma prune (a prefix of the
                # sorted candidates), keep K
                top_cand, cand_idx = rows_topk(row_vals, row_flat, n_cand)
                if gamma is not None:
                    top_cand = torch.where(top_cand >= top_cand[:, :1] - gamma, top_cand, NEG_INF)
                exp_scores = top_cand[:, :K].contiguous()
                keep_idx = cand_idx[:, :K]
                src_beam, new_tok = keep_idx // V, keep_idx % V
                esrc_l.append(src_beam)
                etok_l.append(new_tok)
                flat_beam = (row_base + src_beam).reshape(-1)
                live = (exp_scores > NEG_INF / 2).reshape(-1)
                tok = new_tok.reshape(-1)
                ints_g = exp_ints[flat_beam]
                new_hash = hash_push(ints_g[:, 0], tok)
                cols = [new_hash[:, None]]
                if A >= 1:
                    count = torch.where(live, ints_g[:, 1] + 1, ints_g[:, 1])
                    ring = ints_g[:, 2:]
                    ring = torch.where(
                        live[:, None], torch.cat([tok[:, None], ring[:, :-1]], 1), ring
                    )
                    cols += [count[:, None], ring]
                exp_ints = torch.cat(cols, 1)
                exp_hash = new_hash.reshape(B, K)
                if exp_fh is not None:
                    # push the pre-advance feature of the source row
                    fh_g = exp_fh[:, flat_beam]
                    exp_fh = torch.where(
                        live[None, :, None], torch.cat([exp_feat[flat_beam][None], fh_g[:-1]], 0), fh_g
                    )
                exp_S = lstm_step_reorder(
                    F.embedding(tok.long(), pw["embed"]), exp_S, flat_beam, live,
                    pw["w_ih"], pw["b_ih"], pw["w_hh"], B=B, K=K,
                )
                exp_feat = feature(exp_S)
                if exp_lm is not None:
                    # the LM advances on the new labels (LM index = label -
                    # 1); the cached rows that scored them move with their
                    # source rows, and dead rows keep them (:968-1081)
                    S_lm, lp, ring_lm = exp_lm
                    lp_src = lp[flat_beam]
                    if ring_lm is not None:
                        ring_g = ring_lm[:, flat_beam]
                        ring_lm = torch.where(
                            live[None, :, None], torch.cat([lp_src[None], ring_g[:-1]], 0), ring_g
                        )
                    lm_tok = (tok.long() - 1).clamp(min=0)
                    S_lm = lstm_step_reorder(
                        F.embedding(lm_tok, lw["embed"]), S_lm, flat_beam, live,
                        lw["w_ih"], lw["b_ih"], lw["w_hh"], B=B, K=K,
                    )
                    logits = self.lm.decoder.head(lstm_feat(S_lm, L_lm)[:, : lw["H"]])
                    lp = torch.where(live[:, None], torch.log_softmax(logits.float(), -1), lp_src)
                    exp_lm = (S_lm, lp, ring_lm)
                versions.append((exp_S, exp_ints, exp_fh, exp_lm))

            # materialise the pool's states: per-version row gathers selected
            # by each slot's version; inactive utterances keep the old beam
            flat_slot = (row_base + pool_slot).reshape(-1)
            flat_ver = pool_ver.reshape(-1)
            keep_bk = keep_old[:, None].expand(B, K).reshape(-1)

            def gather_versions(old, leaves, axis=0):
                shape = [1] * old.dim()
                shape[axis] = BK
                out = leaves[0].index_select(axis, flat_slot)
                for v in range(1, len(leaves)):
                    pick = (flat_ver == v).reshape(shape)
                    out = torch.where(pick, leaves[v].index_select(axis, flat_slot), out)
                return torch.where(keep_bk.reshape(shape), old, out)

            S = gather_versions(S, [v[0] for v in versions])
            ints = gather_versions(ints, [v[1] for v in versions])
            if fh is not None:
                fh = gather_versions(fh, [v[2] for v in versions], 1)
            if lm is not None:
                lm = tuple(
                    None if lm[i] is None
                    else gather_versions(lm[i], [v[3][i] for v in versions], 1 if i == 2 else 0)
                    for i in range(3)
                )
            scores = torch.where(keep_old[:, None], scores, pool_scores)
            bps.append(
                tuple(torch.stack(x).to(i32) for x in (fp_l, msrc_l, esrc_l, etok_l))
            )

        # ---- the reverse backpointer walk, then forward-order tokens
        fp_a, msrc_a, esrc_a, etok_a = (torch.stack(x) for x in zip(*bps))
        order = torch.argsort(-scores, dim=1, stable=True)
        scores_sorted = scores.gather(1, order)
        active = (torch.arange(T_enc, device=dev)[:, None] < enc.src_lengths[None, :]).to(i32)
        toks_e, valid_e = aes_backtrace(
            active, fp_a, msrc_a, esrc_a, etok_a, order.to(i32), n_exp
        )
        # emission order is frames descending, rounds as stored: flip the
        # frames, and one cumsum gives each token its place from the end
        em_tok = torch.flip(toks_e, [0]).reshape(T_enc * n_exp, B, K)
        em_val = torch.flip(valid_e, [0]).reshape(T_enc * n_exp, B, K) > 0
        cum = torch.cumsum(em_val.long(), 0)
        total = cum[-1]
        fwd = torch.where(em_val & (total - cum < L_max), total - cum, L_max)
        out = torch.zeros((B, K, L_max + 1), dtype=i32, device=dev)
        out.scatter_(2, fwd.permute(1, 2, 0), em_tok.permute(1, 2, 0))
        lens = torch.clamp(total, max=L_max).to(i32)
        # one int32 tensor [B, K, 2 + L_max]: score bits, length, tokens
        return torch.cat(
            [scores_sorted.view(i32)[..., None], lens[..., None], out[:, :, :L_max]], 2
        )

    def decode_async(self, batch: Dict[str, Any]):
        """Launch the search on the model's device; the host fetch is
        deferred to ``collect``. ``batch`` holds ``src_frames`` [B, T, F] and
        ``src_lengths`` [B] (tensors or arrays); frames are cast to the
        model's parameter dtype."""
        param = next(self.model.parameters())
        src_frames = torch.as_tensor(batch["src_frames"], device=param.device, dtype=param.dtype)
        src_lengths = torch.as_tensor(batch["src_lengths"], device=param.device)
        L_max = max(int(src_frames.shape[1] * self.max_out_factor), 8)
        return self._run(src_frames, src_lengths, L_max), L_max

    def collect(self, handle) -> List[List[Dict[str, Any]]]:
        """Fetch and unpack a ``decode_async`` handle into n-best lists, best
        first (the JAX ``collect`` format)."""
        packed, L_max = handle
        packed = packed.cpu().numpy()
        scores = np.ascontiguousarray(packed[:, :, 0]).view(np.float32)
        lens = packed[:, :, 1].astype(np.int64)
        tokens = packed[:, :, 2 : 2 + L_max]
        results = []
        for b in range(scores.shape[0]):
            hyps = [
                {"tokens": tokens[b, k, : lens[b, k]].astype(np.int32), "score": float(scores[b, k])}
                for k in range(scores.shape[1])
                if scores[b, k] > NEG_INF / 2
            ]
            if not hyps:
                hyps = [{"tokens": np.zeros(0, np.int32), "score": NEG_INF}]
            results.append(hyps)
        return results

    def decode(self, batch: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        return self.collect(self.decode_async(batch))
