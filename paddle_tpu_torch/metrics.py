"""Host-side metric accumulators (python/paddle/fluid/metrics.py:57-566).

The port's own copy of ``paddle_tpu/metrics.py``, which needs numpy only.
"""

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).sum()) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).flatten()
        labels = np.asarray(labels).astype(np.int64).flatten()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).flatten()
        labels = np.asarray(labels).astype(np.int64).flatten()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(MetricBase):
    """Streaming AUC by thresholded confusion counts (metrics.py:463)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).flatten()
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.flatten()
        idx = np.minimum((pos_prob * self._num_thresholds).astype(int),
                         self._num_thresholds)
        for i, lbl in zip(idx, labels):
            if lbl:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no updates yet")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py
    DetectionMAP over detection_map_op.cc), computed host-side over the
    framework's fixed-capacity detection outputs.

    update(dets, det_counts, gt_boxes, gt_labels, gt_counts) per batch:
    dets [B, K, 6] = (label, score, x1, y1, x2, y2); gt_boxes [B, G, 4];
    gt_labels [B, G]; counts give valid rows.  eval() -> mAP (11-point
    or integral)."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 ap_version="integral", evaluate_difficult=True):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._dets = []          # (img, label, score, box)
        self._gts = []           # (img, label, box)
        self._img = 0

    def update(self, dets, det_counts, gt_boxes, gt_labels, gt_counts):
        dets = np.asarray(dets)
        det_counts = np.asarray(det_counts).reshape(-1)
        gt_boxes = np.asarray(gt_boxes)
        gt_labels = np.asarray(gt_labels)
        gt_counts = np.asarray(gt_counts).reshape(-1)
        for b in range(dets.shape[0]):
            img = self._img + b
            for k in range(int(det_counts[b])):
                lbl, score = int(dets[b, k, 0]), float(dets[b, k, 1])
                self._dets.append((img, lbl, score, dets[b, k, 2:6]))
            for g in range(int(gt_counts[b])):
                self._gts.append((img, int(gt_labels[b].reshape(-1)[g]),
                                  gt_boxes[b, g]))
        self._img += dets.shape[0]

    @staticmethod
    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[0] * wh[1]
        ua = (a[2] - a[0]) * (a[3] - a[1]) + \
            (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / ua if ua > 0 else 0.0

    def eval(self, executor=None):
        labels = sorted({l for _, l, _ in self._gts})
        aps = []
        for cls in labels:
            gts = [(i, box) for i, l, box in self._gts if l == cls]
            npos = len(gts)
            taken = set()
            dets = sorted([d for d in self._dets if d[1] == cls],
                          key=lambda d: -d[2])
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for di, (img, _, _, box) in enumerate(dets):
                best, best_j = 0.0, -1
                for j, (gi, gbox) in enumerate(gts):
                    if gi != img or j in taken:
                        continue
                    ov = self._iou(box, gbox)
                    if ov > best:
                        best, best_j = ov, j
                if best >= self.overlap_threshold and best_j >= 0:
                    tp[di] = 1
                    taken.add(best_j)
                else:
                    fp[di] = 1
            if npos == 0:
                continue
            rec = np.cumsum(tp) / npos
            prec = np.cumsum(tp) / np.maximum(
                np.cumsum(tp) + np.cumsum(fp), 1e-9)
            if self.ap_version == "11point":
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0
                              for t in np.linspace(0, 1, 11)])
            else:
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(np.sum(
                    (mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
