"""Plain reference of RobustNet's ISW (Choi et al., CVPR 2021; network/deepv3.py,
network/cov_settings.py, network/instance_whitening.py), DeepR50V3PlusD.

DeepLabV3+ R50-D16 with ``wt_layer`` (0,0,2,2,2,0,0) (``common.py``): a
non-affine InstanceNorm as the stem's norm and after layer1's and layer2's
last residual adds, whose maps (before the ReLU) the whitening loss reads,
and the DSN head on layer3 (3x3 conv to 512, BN, ReLU, dropout 0.1, 1x1).

The objective (network/deepv3.py:548-585):
  CE(logits) + 0.4 CE(dsn logits, labels nearest-resized to their size)
  + 0.6 * (1 / maps) * sum over maps of the batch mean of
    max(0, sum |cov * mask| / count),
with ``cov = f f^T / (HW - 1) + 1e-5 I`` of each sample's (C, HW) map.

The masks come from the statistics pass (deepv3.py:478-545,
cov_settings.py:16-89): pairs of views of the same images through the
eval-mode model, each map's per-sample ``cov`` (upper triangle, off the
diagonal) and its variance over the batch, summed over the pairs and
averaged (``statistics_variances``); a 1-D k-means into ``clusters``
clusters of those values; the entries outside the lowest cluster, taken
as the largest by variance, are the mask, and their count is ``count``
(``masks_of``). The k-means is the deterministic
Lloyd iteration over quantile-initialised centroids that stands in for the
``kmeans1d`` package (the program's ``nn/cov_settings.py`` uses the same).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import common


class ISW(common.DeepLabV3Plus):
    def __init__(self, cfg: dict):
        m = cfg["model"]
        super().__init__(m["num_classes"], m["wt_layer"], m["blocks"], m["aspp_rates"],
                         use_dsn=True)

    def trunk(self, x: torch.Tensor, w_arr: list):
        low = self.layer1(self.stem(x, w_arr), w_arr)
        aux_in = self.layer3(self.layer2(low, w_arr), w_arr)
        return low, aux_in, self.layer4(aux_in, w_arr)

    def forward(self, x: torch.Tensor, keep=None):
        """Eval: the logits. Train: (logits, dsn logits, whitening maps)."""
        h, w = int(x.shape[2]), int(x.shape[3])
        w_arr: list = []
        low, aux_in, feat = self.trunk(x, w_arr)
        logits = common.upsample(self.final2(self.decode(self.aspp(feat), low)), (h, w))
        if not self.training:
            return logits
        return logits, self.dsn_head(aux_in, keep), w_arr


def build(cfg: dict, train: bool) -> ISW:
    return ISW(cfg).train(train)


def whitening_loss(w_arr: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                   counts: Sequence[float]) -> torch.Tensor:
    total = 0.0
    for f_map, mask, count in zip(w_arr, masks, counts):
        n, c, h, w = f_map.shape
        f = f_map.float().reshape(n, c, h * w)
        cov = torch.bmm(f, f.transpose(1, 2)) / (h * w - 1)
        cov = cov + 1e-5 * torch.eye(c, dtype=cov.dtype, device=cov.device)
        off = (cov * mask).abs().sum(dim=(1, 2))
        total = total + (off / count).clamp_min(0.0).mean()
    return total / len(w_arr)


def objective(cfg: dict, masks: Sequence[torch.Tensor], counts: Sequence[float],
              keep_of) -> callable:
    m, t = cfg["model"], cfg["train"]
    ignore = t["ignore_index"]

    def fn(model, step: int, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        images, labels = batch
        logits, aux, w_arr = model(images, keep_of(step))
        main = common.cross_entropy(logits, labels, ignore)
        dsn = common.cross_entropy(aux, common.dsn_labels(labels, aux.shape[2:]), ignore)
        wt = whitening_loss(w_arr, masks, counts)
        loss = main + m["aux_weight"] * dsn + m["wt_reg_weight"] * wt
        return loss, {"loss": loss.detach(), "loss_main": main.detach(),
                      "loss_aux": dsn.detach(), "loss_wt": wt.detach()}
    return fn


def kmeans_1d(values: np.ndarray, k: int, iters: int = 100) -> np.ndarray:
    """Cluster assignments of 1-D values, clusters ordered by centroid."""
    v = np.asarray(values, np.float64).ravel()
    k = min(k, len(np.unique(v)))
    centroids = np.quantile(v, np.linspace(0, 1, k))
    for _ in range(iters):
        assign = np.argmin(np.abs(v[:, None] - centroids[None, :]), axis=1)
        new = np.array([v[assign == j].mean() if np.any(assign == j) else centroids[j]
                        for j in range(k)])
        if np.allclose(new, centroids):
            break
        centroids = new
    order = np.argsort(centroids)
    remap = np.empty_like(order)
    remap[order] = np.arange(k)
    return remap[assign]


@torch.no_grad()
def statistics_variances(model: ISW, view_pairs) -> List[np.ndarray]:
    """The statistics pass: the eval-mode model over each pair of NCHW fp32
    view batches; each map's variance over the batch of each off-diagonal
    covariance entry (upper triangle; 0 elsewhere), averaged over the
    pairs, (C, C) float32."""
    model.eval()
    sums: List[np.ndarray] = []
    for a, b in view_pairs:
        w_arr: list = []
        model.trunk(torch.cat([a, b], dim=0), w_arr)
        for i, f_map in enumerate(w_arr):
            n, c, h, w = f_map.shape
            f = f_map.double().reshape(n, c, h * w)
            cov = torch.bmm(f, f.transpose(1, 2)) / (h * w - 1)
            cov = cov + 1e-5 * torch.eye(c, dtype=cov.dtype, device=cov.device)
            cov = cov * torch.triu(torch.ones(c, c, dtype=cov.dtype, device=cov.device), 1)
            var = cov.var(dim=0, unbiased=True).float().cpu().numpy()
            if len(sums) <= i:
                sums.append(var)
            else:
                sums[i] = sums[i] + var
    return [total / np.float32(len(view_pairs)) for total in sums]


def masks_of(variances: Sequence[np.ndarray], clusters: int
             ) -> Tuple[List[np.ndarray], List[float]]:
    """Each map's mask and count from its variances: a 1-D k-means into
    ``clusters`` clusters; the entries outside the lowest cluster, taken as
    the largest by variance."""
    masks, counts = [], []
    for total in variances:
        c = total.shape[0]
        var = np.asarray(total).ravel()
        assign = kmeans_1d(var, clusters)
        sensitive = int((assign != 0).sum())
        mask = np.zeros(c * c, np.float32)
        mask[np.argsort(var)[::-1][:sensitive]] = 1
        masks.append(mask.reshape(c, c))
        counts.append(float(mask.sum()))
    return masks, counts


def template(cfg: dict, train: bool):
    with torch.device("meta"):
        return build(cfg, train).state_dict()


def train_readings(cfg: dict, seed: int, batches, device, rounding=None, pool=None,
                   given=None) -> dict:
    """The reference's statistics pass on the seed's view pairs of ``pool``
    and its three steps on ``batches``, with the seed's dropout masks:
    each map's variances of covariance, each step's loss and its parts,
    each leaf's first gradient norm and its change after the last step.

    The steps whiten with ``given``'s masks and counts, the statistics pass
    of the run that is judged (the program, or the control in its place),
    so the two runs' steps are the same objective; the masks returned are
    then the reference's k-means of ``given``'s variances, which judge that
    run's own. Without ``given``, the steps take the masks of the
    reference's own variances, and those are returned."""
    weights = inputs.weights(template(cfg, True), seed, device)
    with torch.device(device):
        model = build(cfg, True)
    model.load_state_dict(weights, strict=True)
    del weights
    m, t = cfg["model"], cfg["train"]
    pairs = [tuple(torch.from_numpy(v).to(device).permute(0, 3, 1, 2).contiguous() for v in p)
             for p in inputs.view_pairs(cfg, pool[0], seed)]
    with common.exact_fp32(), common.rounded(rounding):
        variances = statistics_variances(model, pairs)
        del pairs
        masks, counts = masks_of(variances if given is None else given["variances"],
                                 m["clusters"])
        steps_masks, steps_counts = (masks, counts) if given is None else \
            (given["masks"], given["counts"])
        model.train()
        side = t["crop_size"] // m["output_stride"]
        shape = (batches[0][0].shape[0], m["dsn_dim"], side, side)
        fn = objective(cfg, [torch.as_tensor(k, device=device) for k in steps_masks],
                       steps_counts,
                       lambda step: inputs.keep_mask(shape, m["dsn_dropout"], seed, step, device))
        parts, grads, change = common.sgd_steps(model, batches, fn, t["lr"], t["momentum"],
                                                t["weight_decay"], t["max_iter"], t["poly_power"])
    return {"parts": parts, "grad": grads, "change": change, "variances": variances,
            "masks": masks, "counts": counts}


def train_work(cfg: dict, gates=None) -> tuple:
    """(FLOPs, resizes) of one train step."""
    m, t = cfg["model"], cfg["train"]
    n, s = t["batch_size"], t["crop_size"]
    side = s // m["output_stride"]
    with torch.device("meta"):
        model = build(cfg, True)
        masks = [torch.empty(c, c) for c in m["whitened_channels"]]
        keep = torch.empty((n, m["dsn_dim"], side, side), dtype=torch.bool)
        fn = objective(cfg, masks, [1.0] * len(masks), lambda step: keep)
        batch = (torch.empty(n, 3, s, s), torch.zeros(n, s, s, dtype=torch.long))
        return common.count_work(model, fn, batch)

