"""Cross-modal retrieval over extracted NCE-space embeddings (counterpart
of scripts/retrieval.py).

Reads the .npz that ``extract_features --space nce`` writes (the
L2-normalized projection-head embeddings of both modalities, the space
the memory banks live in, reference criterions/avid.py:47-56) and
reports video->audio and audio->video recall@K and the median rank:

    python -m avid_cma_tpu_torch.scripts.extract_features <data.yaml> <model.yaml> \\
        --space nce --out feats.npz
    python -m avid_cma_tpu_torch.scripts.retrieval feats.npz [--ks 1 5 10]

Scores are cosine similarities (the embeddings arrive unit-norm); the
true match of item i is the other modality's row i. Numpy only: it runs
on any host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def recall_metrics(query: np.ndarray, gallery: np.ndarray, ks=(1, 5, 10)):
    """query, gallery (N, D), row i of each the true pair -> {'R@k': pct,
    ..., 'median_rank': r, 'n': N}, rank 1 the best. Ties count against
    the true match (it ranks below every impostor that scores as high),
    so constant embeddings cannot fake R@k."""
    if query.shape != gallery.shape:
        raise ValueError(f"shape mismatch: {query.shape} vs {gallery.shape}")
    n = query.shape[0]
    sim = query @ gallery.T  # (N, N)
    true_score = np.diag(sim)
    # 1 + #{j != i : sim[i, j] >= sim[i, i]}: the true match's own >= hit is the 1
    ranks = (sim >= true_score[:, None]).sum(axis=1)
    out = {f"R@{k}": 100.0 * float((ranks <= k).mean()) for k in ks}
    out["median_rank"] = float(np.median(ranks))
    out["n"] = n
    return out


def evaluate(npz_path: str, ks=(1, 5, 10)):
    """{'v2a': {...}, 'a2v': {...}} of an ``extract_features --space nce``
    output (keys feat_video, feat_audio, row-aligned by 'index'; rows of
    a repeated index are dropped, as their exact ties would count as
    misses)."""
    data = np.load(npz_path)
    for key in ("feat_video", "feat_audio"):
        if key not in data:
            raise KeyError(f"{npz_path} has no '{key}': produce it with "
                           "extract_features --space nce")
    v, a = data["feat_video"], data["feat_audio"]
    if "index" in data:
        _, keep = np.unique(np.asarray(data["index"]), return_index=True)
        if keep.shape[0] != v.shape[0]:
            keep = np.sort(keep)
            v, a = v[keep], a[keep]
    return {"v2a": recall_metrics(v, a, ks), "a2v": recall_metrics(a, v, ks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("npz", help="extract_features --space nce output")
    p.add_argument("--ks", type=int, nargs="+", default=[1, 5, 10])
    args = p.parse_args(argv)
    print(json.dumps(evaluate(args.npz, ks=tuple(args.ks))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
