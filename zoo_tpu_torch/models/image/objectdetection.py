"""SSD object detection (counterpart of
``zoo_tpu/models/image/objectdetection.py``).

A strided conv backbone emits multi-scale feature maps, shared 3x3 conv
heads predict per-anchor class scores and box deltas, and decoding and
NMS run as tensor math with fixed shapes. The anchors and the target
assignment are host numpy, copied from the JAX module; everything else
runs on the model's device. The convolutions are the reference conv
(``conv2d_plain``: f32 sums, TF32 off), as the JAX model's are
``lax.conv`` outside any Pallas kernel, and ``fit_detection``'s Adam is
optax's ``adam`` arithmetic in plain PyTorch.

Where the JAX module relies on an order, the port keeps it: NMS ranks by
a stable descending sort (``lax.top_k`` puts the lower index first on
ties; ``torch.topk`` promises no order), and hard-negative mining ranks
by stable sorts (``jnp.argsort`` is stable; flat backgrounds give many
anchors exactly equal losses). The NMS scan stays sequential over rank,
as the JAX ``lax.scan``, and runs batched over the images.

Detection output follows the original's ``ImageDetection`` layout: per
image, (N, 6) rows of [label, score, x1, y1, x2, y2], normalized.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from zoo_tpu_torch.ops.kernels.conv import conv2d_plain
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_initializer,
    tree_leaves,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    KerasNet,
    _placed,
)


def generate_anchors(feature_sizes: Sequence[int],
                     scales: Sequence[float],
                     aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)
                     ) -> np.ndarray:
    """All anchors over all scales, (A, 4) as [cx, cy, w, h]
    normalized."""
    out = []
    for fs, scale in zip(feature_sizes, scales):
        step = 1.0 / fs
        for i in range(fs):
            for j in range(fs):
                cx, cy = (j + 0.5) * step, (i + 0.5) * step
                for ar in aspect_ratios:
                    w = scale * np.sqrt(ar)
                    h = scale / np.sqrt(ar)
                    out.append([cx, cy, w, h])
    return np.asarray(out, np.float32)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 variance: Tuple[float, float] = (0.1, 0.2)) -> torch.Tensor:
    """SSD delta decoding -> [x1, y1, x2, y2]; ``deltas`` (..., A, 4)
    over ``anchors`` (A, 4)."""
    cxcy = anchors[..., :2] + deltas[..., :2] * variance[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(deltas[..., 2:] * variance[1])
    return torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1)


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of ``boxes_a`` (..., N, 4) with every box of
    ``boxes_b`` (..., M, 4): (..., N, M)."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    inter = torch.prod(torch.clamp(rb - lt, min=0), dim=-1)
    area_a = torch.prod(boxes_a[..., 2:] - boxes_a[..., :2], dim=-1)
    area_b = torch.prod(boxes_b[..., 2:] - boxes_b[..., :2], dim=-1)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-8)


def top_k_stable(scores: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest along the last axis, descending,
    the lower index first among equal scores."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, top_k: int = 100,
        iou_threshold: float = 0.45
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape greedy NMS over ``boxes`` (..., A, 4) and ``scores``
    (..., A), batched over the leading axes: the ``top_k`` by score,
    then a scan over rank order in which each surviving box suppresses
    the later boxes it overlaps above ``iou_threshold`` (suppressed
    entries keep score 0). Returns (top boxes, kept scores, indices)."""
    k = min(top_k, scores.shape[-1])
    top_scores, idx = top_k_stable(scores, k)
    top_boxes = torch.gather(boxes, -2,
                             idx[..., None].expand(*idx.shape, 4))
    ious = iou_matrix(top_boxes, top_boxes)
    over = ious > iou_threshold
    later = torch.arange(k, device=scores.device)
    keep = torch.ones(scores.shape[:-1] + (k,), dtype=torch.bool,
                      device=scores.device)
    for i in range(k):
        suppress = over[..., i, :] & (later > i) & keep[..., i:i + 1]
        keep = keep & ~suppress
    return top_boxes, torch.where(keep, top_scores,
                                  torch.zeros_like(top_scores)), idx


def encode_targets(anchors: np.ndarray, gt_boxes: np.ndarray,
                   gt_labels: np.ndarray, iou_threshold: float = 0.5,
                   variance: Tuple[float, float] = (0.1, 0.2)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """SSD target assignment for ONE image (host side, numpy).

    ``gt_boxes``: (G, 4) [x1,y1,x2,y2] normalized; ``gt_labels``: (G,)
    ints >= 1 (0 is background). Returns (cls_t (A,), box_t (A, 4)):
    each anchor matched to its best-IoU ground truth when IoU >=
    threshold, plus every gt's best unclaimed anchor, others background.
    Box targets are the inverse of :func:`decode_boxes`'s transform."""
    A = anchors.shape[0]
    cls_t = np.zeros((A,), np.int32)
    box_t = np.zeros((A, 4), np.float32)
    if len(gt_boxes) == 0:
        return cls_t, box_t
    ax1y1 = anchors[:, :2] - anchors[:, 2:] / 2
    ax2y2 = anchors[:, :2] + anchors[:, 2:] / 2
    lt = np.maximum(ax1y1[:, None], gt_boxes[None, :, :2])
    rb = np.minimum(ax2y2[:, None], gt_boxes[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(anchors[:, 2:], axis=-1)
    area_g = np.prod(gt_boxes[:, 2:] - gt_boxes[:, :2], axis=-1)
    iou = inter / (area_a[:, None] + area_g[None] - inter + 1e-9)
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    pos = best_iou >= iou_threshold
    # bipartite step: every gt claims its single best UNCLAIMED anchor,
    # even under the threshold, so no object is left unmatched
    claimed = set()
    for g in range(len(gt_boxes)):
        for a in np.argsort(-iou[:, g]):
            a = int(a)
            if a not in claimed:
                claimed.add(a)
                best_gt[a] = g
                pos[a] = True
                break
    matched = gt_boxes[best_gt]
    cxcy_g = (matched[:, :2] + matched[:, 2:]) / 2
    wh_g = matched[:, 2:] - matched[:, :2]
    d_xy = (cxcy_g - anchors[:, :2]) / (anchors[:, 2:] * variance[0])
    d_wh = np.log(np.clip(wh_g / anchors[:, 2:], 1e-6, None)) / variance[1]
    box_t[pos] = np.concatenate([d_xy, d_wh], axis=-1)[pos]
    cls_t[pos] = gt_labels[best_gt[pos]]
    return cls_t, box_t


def multibox_loss(cls_logits, box_deltas, cls_t, box_t,
                  neg_pos_ratio: int = 3):
    """SSD multibox loss of a batch: softmax CE over matched anchors and
    hard-negative-mined background anchors (``neg_pos_ratio`` negatives
    a positive, picked by loss rank) plus smooth-L1 on the positives'
    box deltas, per image over its positive count, mean over images."""
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    cls_t = cls_t.long()
    ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    pos = cls_t > 0                                   # (B, A)
    n_pos = torch.clamp(pos.sum(dim=1), min=1)
    # rank background anchors by their CE; stable, as jnp.argsort, so
    # equal losses keep anchor order
    neg_ce = torch.where(pos, torch.full_like(ce, -float("inf")), ce)
    rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True),
                         dim=1, stable=True)
    n_neg = torch.minimum(neg_pos_ratio * n_pos, pos.shape[1] - n_pos)
    neg = rank < n_neg[:, None]
    zero = torch.zeros_like(ce)
    cls_loss = torch.where(pos | neg, ce, zero).sum(dim=1) / n_pos
    diff = torch.abs(box_deltas.float() - box_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).sum(-1)
    box_loss = torch.where(pos, sl1, zero).sum(dim=1) / n_pos
    return (cls_loss + box_loss).mean()


class _MultiBoxHead(Layer):
    """Shared conv head on one feature map: per-anchor class scores and
    box deltas."""

    def __init__(self, n_anchors: int, n_classes: int, **kwargs):
        super().__init__(**kwargs)
        self.n_anchors = n_anchors
        self.n_classes = n_classes

    def build(self, generator, input_shape):
        cin = input_shape[-1]
        init = get_initializer("glorot_uniform")
        a = self.n_anchors
        dev = generator.device
        return {
            "cls_w": init(generator, (3, 3, cin, a * self.n_classes)),
            "cls_b": torch.zeros((a * self.n_classes,), device=dev),
            "box_w": init(generator, (3, 3, cin, a * 4)),
            "box_b": torch.zeros((a * 4,), device=dev),
        }

    def call(self, params, inputs, *, training=False, rng=None):
        b = inputs.shape[0]
        cls = (conv2d_plain(inputs, params["cls_w"]) + params["cls_b"]
               ).reshape(b, -1, self.n_classes)
        box = (conv2d_plain(inputs, params["box_w"]) + params["box_b"]
               ).reshape(b, -1, 4)
        return cls, box


def _adam_update(params: List[torch.Tensor], grads, mu, nu, count: int,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
    """optax ``adam(lr)`` in place: the moments, then the bias-corrected
    step ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr`` and added."""
    dev = params[0].device
    # f32 powers, as optax takes them; divisions by 0-dim tensors (a CUDA
    # division by a Python scalar multiplies by its reciprocal)
    bc1, bc2 = (torch.tensor(1.0 - float(np.float32(b) ** np.float32(count)),
                             dtype=torch.float32, device=dev)
                for b in (b1, b2))
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.add_(u * -lr)


class SSD(KerasNet):
    """Compact SSD over a strided conv backbone. ``predict_detections``
    returns the original's row layout."""

    def __init__(self, n_classes: int, input_size: int = 128,
                 feature_channels: Sequence[int] = (32, 64, 128),
                 aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5),
                 name: Optional[str] = None):
        super().__init__(name=name or "ssd")
        self.n_classes = int(n_classes)  # including background class 0
        self.input_size = int(input_size)
        self.channels = list(feature_channels)
        self.aspect_ratios = list(aspect_ratios)
        # a stride-4 stem, then one stride-2 stage a scale; SAME padding
        # gives ceil(in / stride)
        self.feature_sizes = []
        fs = -(-self.input_size // 4)
        for _ in self.channels:
            fs = -(-fs // 2)
            self.feature_sizes.append(fs)
        self.scales = [0.15 + 0.35 * i / max(len(self.channels) - 1, 1)
                       for i in range(len(self.channels))]
        self.anchors = generate_anchors(self.feature_sizes, self.scales,
                                        self.aspect_ratios)
        self._heads = [_MultiBoxHead(len(self.aspect_ratios),
                                     self.n_classes, name=f"head{i}")
                       for i in range(len(self.channels))]

    @property
    def layers(self):
        return self._heads

    def _input_shapes(self):
        return [(None, self.input_size, self.input_size, 3)]

    def _init_params(self, generator, input_shapes):
        init = get_initializer("glorot_uniform")
        dev = generator.device
        params = {"stem_w": init(generator, (7, 7, 3, 16)),
                  "stem_b": torch.zeros((16,), device=dev)}
        cin = 16
        for i, c in enumerate(self.channels):
            params[f"conv{i}_w"] = init(generator, (3, 3, cin, c))
            params[f"conv{i}_b"] = torch.zeros((c,), device=dev)
            cin = c
        for i, head in enumerate(self._heads):
            shape = (None, self.feature_sizes[i], self.feature_sizes[i],
                     self.channels[i])
            params[self._key_of(head)] = head.build(generator, shape)
        return params

    def _forward(self, params, inputs, *, training, collect=None, rng=None):
        x = inputs[0]

        def conv(x, w, b, s):
            return torch.relu(conv2d_plain(x, w, (s, s)) + b)

        x = conv(x, params["stem_w"], params["stem_b"], 4)
        cls_all, box_all = [], []
        for i, head in enumerate(self._heads):
            x = conv(x, params[f"conv{i}_w"], params[f"conv{i}_b"], 2)
            cls, box = head.call(params[self._key_of(head)], x,
                                 training=training)
            cls_all.append(cls)
            box_all.append(box)
        return torch.cat(cls_all, 1), torch.cat(box_all, 1)

    def _on(self, device) -> torch.device:
        """Params built (seed 0) and placed on ``device`` (default: the
        runtime context's, else the current CUDA device)."""
        dev = _placed(device)
        if self.params is None:
            self.build(torch.Generator(device=dev).manual_seed(0))
        self._place_params(self.params, dev)
        return dev

    # -- training ---------------------------------------------------------
    def fit_detection(self, images: np.ndarray, boxes_list: List,
                      labels_list: List, epochs: int = 10,
                      batch_size: int = 16, lr: float = 1e-3,
                      iou_threshold: float = 0.5, seed: int = 0,
                      verbose: int = 0, device=None) -> List[float]:
        """Train the detector end to end with the multibox loss; returns
        the per-epoch mean losses.

        ``boxes_list[i]``: (G_i, 4) normalized [x1,y1,x2,y2] ground-truth
        boxes of image i; ``labels_list[i]``: (G_i,) int labels >= 1.
        Targets are assigned on the host once (:func:`encode_targets`);
        batches follow ``RandomState(seed)``'s permutation each epoch,
        the ragged tail dropped, as in the JAX module. Runs on the
        current CUDA device unless ``device`` names another; the
        losses are read from the device once an epoch."""
        dev = self._on(device)
        n = len(images)
        # a batch larger than the dataset would train nothing
        batch_size = min(batch_size, n)
        A = self.anchors.shape[0]
        cls_t = np.zeros((n, A), np.int32)
        box_t = np.zeros((n, A, 4), np.float32)
        for i in range(n):
            cls_t[i], box_t[i] = encode_targets(
                self.anchors, np.asarray(boxes_list[i], np.float32),
                np.asarray(labels_list[i], np.int32),
                iou_threshold=iou_threshold)
        leaves = tree_leaves(self.params)
        mu = [torch.zeros_like(p) for p in leaves]
        nu = [torch.zeros_like(p) for p in leaves]
        count = 0
        imgs_all = np.asarray(images, np.float32)
        rs = np.random.RandomState(seed)
        history = []
        for epoch in range(epochs):
            order = rs.permutation(n)
            losses = []
            for s in range(0, n - batch_size + 1, batch_size):
                idx = order[s:s + batch_size]
                x = torch.from_numpy(imgs_all[idx]).to(dev)
                ct = torch.from_numpy(cls_t[idx]).to(dev)
                bt = torch.from_numpy(box_t[idx]).to(dev)
                with torch.enable_grad():
                    cls, box = self._forward(self.params, [x],
                                             training=True)
                    loss = multibox_loss(cls, box, ct, bt)
                grads = torch.autograd.grad(loss, leaves)
                count += 1
                _adam_update(leaves, grads, mu, nu, count, lr)
                losses.append(loss.detach())
            history.append(float(np.mean(
                torch.stack(losses).cpu().numpy().tolist())))
            if verbose:
                print(f"epoch {epoch + 1}/{epochs} "
                      f"multibox_loss={history[-1]:.4f}")
        return history

    # -- detection --------------------------------------------------------
    def detect(self, images, score_threshold: float = 0.3,
               iou_threshold: float = 0.45, top_k: int = 50
               ) -> torch.Tensor:
        """(B, k, 6) detection rows on the params' device, suppressed and
        below-threshold rows with score 0 (fixed shapes)."""
        params = self.params
        x = images if isinstance(images, torch.Tensor) else \
            torch.from_numpy(np.asarray(images, np.float32))
        x = x.to(tree_leaves(params)[0].device)
        anchors = torch.from_numpy(self.anchors).to(x.device)
        with torch.no_grad():
            cls, box = self._forward(params, [x], training=False)
            probs = torch.softmax(cls, dim=-1)
            decoded = decode_boxes(anchors, box)
            # the first class among equal probabilities, as jnp.argmax
            best_cls = torch.argmax(probs[..., 1:], dim=-1)
            best_score = torch.amax(probs[..., 1:], dim=-1)
            boxes, scores, idx = nms(decoded, best_score, top_k,
                                     iou_threshold)
            labels = (torch.gather(best_cls, -1, idx) + 1).float()
            scores = torch.where(scores >= score_threshold, scores,
                                 torch.zeros_like(scores))
            return torch.cat([labels[..., None], scores[..., None], boxes],
                             dim=-1)

    def predict_detections(self, images: np.ndarray,
                           score_threshold: float = 0.3,
                           iou_threshold: float = 0.45,
                           top_k: int = 50, device=None) -> List[np.ndarray]:
        """Per image: (k, 6) rows [label, score, x1, y1, x2, y2] with
        score above 0 (suppressed and below-threshold rows trimmed on
        the host, as in the JAX module). Runs on the current CUDA device
        unless ``device`` names another."""
        self._on(device)
        out = self.detect(images, score_threshold, iou_threshold,
                          top_k).cpu().numpy()
        return [det[det[:, 1] > 0] for det in out]


class ObjectDetector:
    """A detection model with the ImageSet pipeline:
    ``predict_image_set`` resizes each image to the model's input (the
    port's uint8 bilinear resize, cv2's bit for bit), scales to [0, 1]
    and stores each image's rows under ``"predict"``."""

    def __init__(self, model: SSD, label_map: Optional[dict] = None):
        self.model = model
        self.label_map = label_map or {}

    def predict_image_set(self, image_set, score_threshold: float = 0.3,
                          device=None):
        from zoo_tpu_torch.feature.image import resize_linear

        size = self.model.input_size
        imgs = [resize_linear(np.asarray(f["image"]), size, size
                              ).astype(np.float32) / 255.0
                for f in image_set.features]
        dets = self.model.predict_detections(
            np.stack(imgs), score_threshold=score_threshold, device=device)
        for f, det in zip(image_set.features, dets):
            f["predict"] = det
        return image_set

    @staticmethod
    def load_model(path: str, label_map: Optional[dict] = None,
                   device=None) -> "ObjectDetector":
        """A model file of the port (``KerasNet.save``), on the current
        CUDA device unless ``device`` names another."""
        return ObjectDetector(KerasNet.load(path, device=device), label_map)
