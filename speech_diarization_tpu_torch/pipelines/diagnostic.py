"""Diagnostic / research pipeline: whitening, AS-Norm, Viterbi resegmentation,
similarity diagnostics and plots (the JAX package's
``pipelines/diagnostic.py``).

Capability mirror of ``diar_diag.main`` (``diar_diag.py:297-433``): the VAD →
embed → (whiten) → cluster → centroid scores → (AS-Norm) → (Viterbi) → merge →
export chain plus adjacent/non-adjacent cosine-similarity statistics and the
similarity-matrix / histogram plots (``diar_diag.py:274-290``).  The
pipeline runs on its device (``pipeline_kwargs``: ``encoder``, ``vad``,
``device``); the rest is host numpy, with whitening and AS-Norm in torch on
the CPU.  matplotlib is imported only by :func:`plot_diagnostics`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..cluster import asnorm_scores, cluster_embeddings, whiten
from ..config import DiarizationConfig
from ..io.writers import save_csv, save_json, save_srt
from ..ops.viterbi import sticky_transition_logits, viterbi_decode
from ..types import SegmentArray
from ..utils.logging import get_logger
from .diarize import DiarizationPipeline

log = get_logger("diagnostic")


@dataclass
class DiagnosticReport:
    segments: SegmentArray
    labels: np.ndarray
    embeddings: np.ndarray
    adjacent_sims: np.ndarray
    nonadjacent_sims: np.ndarray
    speakers: list[str] = field(default_factory=list)

    def similarity_stats(self) -> dict[str, float]:
        return {
            "adjacent_mean": float(self.adjacent_sims.mean()),
            "adjacent_std": float(self.adjacent_sims.std()),
            "nonadjacent_mean": float(self.nonadjacent_sims.mean()),
            "nonadjacent_std": float(self.nonadjacent_sims.std()),
        }

    def tuning_hint(self) -> str:
        """The printed advice of ``diar_diag.py:426-433``: overlapping
        distributions -> stronger morphology/embeddings/AS-Norm."""
        s = self.similarity_stats()
        sep = s["adjacent_mean"] - s["nonadjacent_mean"]
        spread = s["adjacent_std"] + s["nonadjacent_std"]
        if sep < spread:
            return ("adjacent and non-adjacent similarity distributions overlap: "
                    "consider longer morph_open_ms, a stronger embedding backend, "
                    "AS-Norm, or density clustering")
        return "similarity distributions are well separated"


def diagnose(
    source,
    cfg: DiarizationConfig | None = None,
    out_dir: str | Path | None = None,
    use_whiten: bool = True,
    use_asnorm: bool = True,
    use_vbx: bool = True,
    cluster_method: str = "hdbscan",
    hmm_alpha: float = 0.995,
    save_plots: bool = True,
    **pipeline_kwargs,
) -> DiagnosticReport:
    cfg = cfg or DiarizationConfig()
    pipe = DiarizationPipeline(cfg, **pipeline_kwargs)
    result = pipe(source, collect_diagnostics=True)
    segs = result.vad_segments
    # the diagnostic pipeline embeds VAD segments directly (no SCD), so
    # derive embeddings for the VAD segmentation from the shared grid
    from ..segment.embed import segment_embeddings_from_grid

    embs = segment_embeddings_from_grid(
        result.diagnostics["window_embeddings"],
        result.diagnostics["window_starts_s"],
        cfg.reseg.win_s,
        segs,
    )
    if len(segs) == 0:
        empty = np.zeros((0,), np.float32)
        return DiagnosticReport(segs, np.zeros(0, np.int32), embs, empty, empty)

    if use_whiten and len(segs) > 4:
        embs = whiten(torch.from_numpy(np.asarray(embs, np.float32))).numpy()

    # adjacent vs non-adjacent similarity diagnostics (diar_diag.py:354-365)
    e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9)
    sim = e @ e.T
    n = len(segs)
    adj = np.array([sim[i, i + 1] for i in range(n - 1)]) if n > 1 else np.zeros(1)
    rng = np.random.default_rng(0)
    idxs = rng.integers(0, n, size=min(2000, n * 4))
    idys = rng.integers(0, n, size=min(2000, n * 4))
    nonadj = np.array([sim[i, j] for i, j in zip(idxs, idys) if abs(i - j) > 3])
    if nonadj.size == 0:
        nonadj = np.zeros(1)

    cluster_kwargs: dict[str, Any] = {}
    if cluster_method in ("hdbscan", "hdbscan2"):
        # diar_diag uses min_cluster_size=6/min_samples=3 for long recordings
        # (diar_diag.py:216); scale down for short inputs
        cluster_kwargs["min_cluster_size"] = max(2, min(6, n // 4))
    labels = cluster_embeddings(embs, method=cluster_method, **cluster_kwargs)
    uniq = sorted(int(u) for u in np.unique(labels) if u >= 0)
    if not uniq:
        labels = np.zeros(n, dtype=np.int32)
        uniq = [0]

    centers = np.stack([
        e[labels == k].mean(axis=0) / (np.linalg.norm(e[labels == k].mean(axis=0)) + 1e-9)
        for k in uniq
    ])
    scores = e @ centers.T
    if use_asnorm and n > 4:
        et = torch.from_numpy(np.asarray(e, np.float32))
        scores = asnorm_scores(et, torch.from_numpy(np.asarray(centers, np.float32)),
                               et, topk=min(200, n)).numpy()
    if use_vbx and len(uniq) > 1:
        log_a = sticky_transition_logits(len(uniq), hmm_alpha)
        path = np.asarray(viterbi_decode(scores.astype(np.float32), log_a))
        final_labels = np.array([uniq[p] for p in path], dtype=np.int32)
    else:
        final_labels = np.array([uniq[i] for i in np.argmax(scores, axis=1)],
                                dtype=np.int32)

    labeled = SegmentArray(segs.starts, segs.ends, final_labels)
    from ..segment.merge import merge_adjacent

    merged = merge_adjacent(labeled, gap_s=cfg.vad.min_silence_ms / 1000.0)
    speakers = [f"SPK_{i}" for i in range(len(uniq))]
    report = DiagnosticReport(merged, labels, embs, adj, nonadj, speakers)

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_json(out / "diarization.json", merged)
        save_srt(out / "diarization.srt", merged)
        save_csv(out / "diarization.csv", merged)
        if save_plots:
            plot_diagnostics(out, embs, labels, adj, nonadj)
        log.info("diagnostic outputs -> %s (%s)", out, report.tuning_hint())
    return report


def plot_diagnostics(
    out_dir: str | Path,
    embs: np.ndarray,
    labels: np.ndarray,
    adj_sims: np.ndarray,
    nonadj_sims: np.ndarray,
) -> None:
    """Similarity-matrix heatmap + adjacent/non-adjacent histograms
    (``plot_diagnostics``, ``diar_diag.py:274-290``); 150 dpi PNGs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9)
    sim = e @ e.T
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(sim, vmin=-1, vmax=1, aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_title("Cosine similarity between segments")
    ax.set_xlabel("segment")
    ax.set_ylabel("segment")
    fig.tight_layout()
    fig.savefig(out / "sim_matrix.png", dpi=150)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(adj_sims, bins=60, range=(-1, 1), alpha=0.6, label="adjacent")
    ax.hist(nonadj_sims, bins=60, range=(-1, 1), alpha=0.6, label="non-adjacent")
    ax.legend()
    ax.set_title("Similarity distributions")
    fig.tight_layout()
    fig.savefig(out / "sim_hists.png", dpi=150)
    plt.close(fig)
