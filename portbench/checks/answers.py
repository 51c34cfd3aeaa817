"""``correct`` for the RAG answers: the store's chunks, every retrieval the
index answered against an exact top-k over the vectors it held and the
query it was given, each first-round prompt against the template over
its two best chunks, the prompts' token ids, each answer's text against
its tokens, the store's vectors against the reference's embeddings, and
a sample of the answers' tokens, teacher-forced through the reference
decoder: the gap by which each served token's logit lies below the
reference's best at its position."""

from __future__ import annotations

import numpy as np
import torch

from portbench import corpus
from portbench.checks import common
from portbench.reference import mistral, strict_f32, text, topk

NOT_FOUND = "No information found."
TEMPLATE = ('Use the below articles to answer the subsequent question. If the answer cannot be found, write '
            '"{not_found}"\nArticles:\n{context}\nQuestion: {question}\nAnswer:')  # the answerer's prompt


def question_of(prompt: str) -> str:
    return prompt.rsplit("\nQuestion: ", 1)[1].rsplit("\nAnswer:", 1)[0]


class Check:
    def __init__(self, cell, sys_, data, answers, window, lapsed=()):
        self.cell, self.data, self.answers, self.window = cell, data, answers, window
        self.lapsed = list(lapsed)
        self.tree, self.decoder_tree = sys_["tree"], sys_["decoder_tree"]

    def run(self) -> dict:
        cell, cfg, scfg, probe = self.cell, self.cell.config, self.cell.store_config, self.cell.probe
        dev = cell.reference_device
        t0, t1 = self.window
        ref_chunks = sorted({c for d in self.data["texts"]
                             for c in text.split_chunks(d, scfg["splitter_min_tokens"], scfg["splitter_max_tokens"])})
        asked = {q for q, _r in self.answers + self.lapsed}
        embedded = {t for _t, texts, _v in probe.of("encode") for t in texts}
        chunk_diff = len(set(ref_chunks) - embedded) + len(embedded - set(ref_chunks) - asked)

        # the window's answers: sent or delivered inside it
        window_answers = [(q, r) for q, r in self.answers if r["sent"] < t1 and r["done"] >= t0]
        unanswered = sum(1 for _q, r in window_answers if r["status"] != 200)
        reqs = {}
        for _t, prompt, req in probe.of("submit"):
            if prompt is not None:
                reqs.setdefault(question_of(prompt), []).append((prompt, req))
        mine = [(q, r) for q, r in window_answers if r["status"] == 200 and q in reqs]
        not_answered = sum(1 for _q, r in window_answers if r["status"] == 200) - len(mine)
        # the server answers in order of arrival: a request let lapse at the
        # close while a later one was answered was passed over
        newest = max((r["sent"] for _q, r in self.answers if r["status"] == 200), default=float("-inf"))
        overtaken = sum(1 for _q, r in self.lapsed if r["sent"] < newest - 1.0)

        # retrievals: which chunk each question's hits are, for its prompt
        by_vector = common.encoded_texts(probe)
        vec_of = {}
        for _t, index, key, v in probe.of("index_add"):
            vec_of[(index, key)] = v
        hits = {}  # question -> [(chunk text, score)]
        searched = set()
        for _t, index, qvecs, _ks, results in probe.of("search"):
            searched.add(index)
            for qv, res in zip(qvecs, results):
                q = by_vector.get(np.asarray(qv, np.float32).tobytes())
                hits[q] = [(by_vector.get(np.asarray(vec_of.get((index, key)), np.float32).tobytes()), s)
                           for key, s in res]
        questions = [q for q, _r in mine]
        strict_f32()
        chunk_ids = common.reference_ids(ref_chunks, scfg)
        ref_c = common.reference_embeddings(self.tree, chunk_ids, scfg, dev)
        row = {t: i for i, t in enumerate(ref_chunks)}
        unknown = prompt_bad = unsorted = 0
        for q in questions:
            got = hits.get(q)
            if not got or any(t not in row for t, _s in got):
                unknown += 1
                continue
            unsorted += any(a[1] < b[1] for a, b in zip(got, got[1:]))
            first_prompt = reqs[q][0][0]
            context = "\n\n".join(t for t, _s in got[: cfg["n_starting_documents"]])
            if first_prompt != "user: " + TEMPLATE.format(not_found=NOT_FOUND, context=context, question=q):
                prompt_bad += 1
        retrieval = retrieval_numbers(probe, scfg["index_score_tolerance"], cell.control)

        # prompts' ids and answers' texts
        id_bad = text_bad = 0
        served = []
        for q, r in mine:
            prompt, req = reqs[q][-1]
            if list(req.prompt_ids) != text.hash_ids(prompt, cfg["vocab_size"], cfg["served_positions"]):
                id_bad += 1
            body = r.get("body") or {}
            if body.get("response") != text.decode(req.out):
                text_bad += 1
            served.append(req)
        # the store's vectors in the index the answers searched
        stored = [(by_vector.get(np.asarray(v, np.float32).tobytes()), v)
                  for (index, _key), v in vec_of.items() if index in searched]
        stored = [(row[t], v) for t, v in stored if t in row]
        got = np.stack([np.asarray(v, np.float32) for _r, v in stored]) if stored else np.zeros((0, 1))
        emb_gaps = common.l2_gaps(got, ref_c[[r for r, _v in stored]]) if stored else torch.zeros(0)
        gaps = self._decode_gaps(served, dev)
        numbers = {
            "chunks_not_as_split": chunk_diff,
            "requests_unanswered": unanswered + not_answered,
            "requests_overtaken": overtaken,
            "retrievals_unknown": unknown,
            "retrievals_not_sorted": unsorted,
            "prompts_not_template": prompt_bad,
            "prompt_id_mismatches": id_bad,
            "answer_text_mismatches": text_bad,
            **retrieval,
            **common.gap_stats("embedding_l2", emb_gaps),
            **common.gap_stats("served_logit_gap", gaps),
            "served_logit_flip_share": float((gaps > 0).double().mean()) if len(gaps) else 0.0,
        }
        return {"numbers": numbers, "attempted": len(window_answers), "failed": unanswered + not_answered}

    def _decode_gaps(self, served: list, dev) -> torch.Tensor:
        """Each served token's gap below the reference's best logit at its
        position, over a seeded sample of the served answers with the
        longest in."""
        cell, cfg = self.cell, self.cell.config
        if not served:
            return torch.zeros(0)
        longest = max(range(len(served)), key=lambda i: len(served[i].prompt_ids) + len(served[i].out))
        picked = [served[i] for i in corpus.sample_indices(len(served), cell.traffic["check_answers"],
                                                           cell.seed, 2, must=[longest])]
        out = []
        block = cell.traffic["check_block"]
        for at in range(0, len(picked), block):
            part = [r for r in picked[at : at + block] if r.out]
            seqs = [list(r.prompt_ids) + list(r.out) for r in part]
            pos = [[len(r.prompt_ids) - 1 + j for j in range(len(r.out))] for r in part]
            logits = mistral.logits_at(self.decoder_tree, cfg, seqs, pos, dev)
            for r, lg in zip(part, logits):
                tok = torch.tensor(list(r.out), device=lg.device)
                out.append((lg.max(dim=1).values - lg.gather(1, tok[:, None])[:, 0]).cpu())
            del logits
        return torch.cat(out) if out else torch.zeros(0)


def retrieval_numbers(probe, tolerance: float, control: bool = False) -> dict:
    """Every search the index answered, against the exact float64 cosines
    of the query it was given with the vectors it held then.

    ``retrieval_scores_off``: returned scores more than ``tolerance`` (one
    step of the type the index serves its scores in) from their chunk's
    exact score.  ``retrievals_off_topk``: retrievals holding a chunk whose
    exact score lies below the exact k-th by more than twice that: an index
    whose every score is within ``tolerance`` cannot rank such a chunk into
    its top k.  ``retrievals_malformed``: retrievals of another length than
    ``min(k, held)``, or holding a key twice or a key the index never took.
    The widest score gap and rank excess are readings.  With ``control``
    the float8 top-k answers in the index's place."""
    adds: dict = {}
    for t, index, key, v in probe.of("index_add"):
        adds.setdefault(index, []).append((t, key, v))
    err = excess = 0.0
    scores_off = off = malformed = checked = 0
    for t, index, qvecs, ks, results in probe.of("search"):
        held = {key: v for ta, key, v in adds.get(index, ()) if ta <= t}
        if not held:
            malformed += sum(1 for res in results if res)
            continue
        keys = list(held)
        pos = {key: i for i, key in enumerate(keys)}
        docs = torch.as_tensor(np.stack([np.asarray(held[key], np.float32) for key in keys]))
        queries = torch.as_tensor(np.stack([np.asarray(v, np.float32) for v in qvecs]))
        exact = topk.cosine_scores(queries, docs)
        want = [min(3 if k is None else k, len(keys)) for k in ks]
        if control:
            vals, idx = topk.fp8_cosine_topk(queries, docs, max(want))
            results = [[(keys[int(i)], float(s)) for i, s in zip(idx[r, :w], vals[r, :w])]
                       for r, w in enumerate(want)]
        for r, res in enumerate(results):
            checked += 1
            got = [key for key, _s in res]
            if len(got) != want[r] or len(set(got)) != len(got) or any(key not in pos for key in got):
                malformed += 1
                continue
            e = exact[r, [pos[key] for key in got]]
            kth = float(torch.topk(exact[r], want[r]).values[-1])
            gap = kth - float(e.min())
            excess = max(excess, gap)
            off += gap > 2 * tolerance
            score_gaps = (torch.tensor([s for _k, s in res], dtype=torch.float64) - e).abs()
            scores_off += int((score_gaps > tolerance).sum())
            err = max(err, float(score_gaps.max()))
    return {"retrieval_scores_off": scores_off, "retrievals_off_topk": off, "retrievals_malformed": malformed,
            "retrieval_score_err": err, "retrieval_rank_excess": excess, "retrievals_checked": checked}
