"""The comparisons that decide ``correct``: the numbers, each held against
the limit of its cell (``bench_torch/limits/<cell>.json``); the numbers a
cell's limits do not name are printed beside them.

The reference follows the program's discrete decisions, as a served token
is checked by how far its logit lies below the reference's best, and holds
each kind of decision by the share of them that differ from its own by
more than ``FAR`` of the reference's margin on them (bfloat16 flips
near-ties, which fall under the margin; a decision made by another rule
differs far more often): the decoder's attention masks
(``mask_far_share``), and in training the points the loss samples
(``point_far_share``) and the matcher's assignments (``match_mean_gap``,
the mean excess cost a target under the reference's costs over every
assignment problem of the checked micro-steps). Printed beside them: the
plain shares of differing decisions (``mask_flip_share``,
``point_flip_share``), their tallies by margin, and the largest margins
(``mask_gap``, ``point_gap``, ``match_gap``). Given those, what is left
between the two is arithmetic. Decisions that cannot be followed read
inf.

Serving compares the answers of sampled requests (``ServeGaps``), and that
the requests served again to record the masks gave the window's answers,
bit for bit (``replay_diff``). Training compares the first two updates'
micro-steps by the worst leaf: each step's loss (relative), the first
update's gradient norm of each parameter (as the optimizer's first moment
holds it), and the norm of each parameter's change after the two updates;
and the median leaf's. Leaf gaps are taken against the larger of the leaf's
reference norm and the median leaf's. Leaves whose reference gradient is
under a thousandth of the median leaf's move under AdamW by round-off
alone; they are left out of the change.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

from bench_torch.reference.model import MARGINS, tally

HERE = os.path.dirname(os.path.abspath(__file__))
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median's
FAR = 0.3  # |logit|: a decision that differs by more than this from the reference's own is held


def load_limits(cell: str) -> dict:
    with open(os.path.join(HERE, 'limits', f'{cell}.json')) as f:
        return json.load(f)['limits']


def hold(run, numbers: dict) -> None:
    """The numbers the cell's limits name become its checks; the others
    are printed beside them."""
    limits = load_limits(run.name)
    run.checks = {name: (numbers[name], limit) for name, limit in limits.items()}
    run.notes.update({name: v for name, v in numbers.items() if name not in limits})


def owners(res: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Each pixel's owner, from the serving arrays: the label and the score
    of the kept slot whose segment id the map holds there (label -1 where
    none does)."""
    seg, ids = res['segmentation'].long(), res['segment_ids'].long()
    b, q = ids.shape
    slot = torch.zeros((b, q + 1), dtype=torch.long, device=seg.device)
    slots = torch.arange(q, device=seg.device).expand_as(ids)
    slot.scatter_(1, torch.where(ids >= 0, ids, q), slots)  # id → its slot; q takes the rest
    at = torch.gather(slot, 1, seg.clamp(min=0).flatten(1)).view_as(seg)
    label = torch.where(seg >= 0, torch.gather(res['labels'].long(), 1, at.flatten(1)
                                               ).view_as(seg), -1)
    score = torch.gather(res['scores'].float(), 1, at.flatten(1)).view_as(seg)
    return label, torch.where(seg >= 0, score, 0.0)


class ServeGaps:
    """The serving numbers over every compared request. The compared one,
    ``label_logit_rms_request``: within each label, an image's slot scores
    sorted and raised to the threshold (so a slot kept on one side and just
    dropped on the other reads only as far as it fell, and which pairs fill
    the slots below the threshold does not matter), their gap to the
    reference's in log-odds (where a class probability near 1 does not
    hide its error), root-mean-square over the slots above the threshold
    on either side, the worst request. Printed beside it:
    ``label_rms_request``, the same in probability over every slot;
    ``owner_far_share``, the share of pixels, pooled over every compared
    image, whose owner in the id map differs (another label, none on one
    side, or a score more than ``OWNER_SCORE`` away) where the reference's
    mask logits lie more than ``FAR`` from changing it
    (``reference.postprocess.answers``' ``margin``), with ``owner_share``,
    every pixel whose owner differs, and ``owner_tally``, those by margin
    (``reference.model.tally``); ``score_gap``, the widest gap of one
    image's sorted, threshold-raised scores; ``label_mass_all``, each
    label's scores summed over the slots against the reference's, over its
    total; ``cover_gap``, the largest share of an image's pixels that a kept
    slot covers on one side and none on the other."""

    OWNER_SCORE = 0.04

    def __init__(self, threshold: float, labels: int):
        self.threshold, self.labels = threshold, labels
        self.label_logit_rms_request = self.label_rms_request = 0.0
        self.score_gap = self.cover_gap = self.mass_diff = self.mass = 0.0
        self.owner_diff = self.pixels = 0
        self.owner_tally = [0] * (len(MARGINS) + 1)

    def _sorted(self, s):
        return torch.sort(s.float().clamp(min=self.threshold), dim=-1, descending=True).values

    def add(self, res: dict, ref: dict) -> None:
        """A request's answers (the serving arrays) and the reference's
        (``reference.postprocess.answers``)."""
        diff = (self._sorted(res['scores']) - self._sorted(ref['scores'])).abs()
        self.score_gap = max(self.score_gap, float(diff.amax()))
        square = logit_sq = active = 0.0
        for c in range(self.labels):
            mine = self._sorted(torch.where(res['labels'] == c, res['scores'].float(), 0.0))
            theirs = self._sorted(torch.where(ref['labels'] == c, ref['scores'].float(), 0.0))
            square += float((mine - theirs).pow(2).sum())
            on = (mine > self.threshold) | (theirs > self.threshold)
            active += float(on.sum())
            odds = [torch.logit(x.clamp(max=1 - 1e-4)) for x in (mine, theirs)]
            logit_sq += float(((odds[0] - odds[1]) * on).pow(2).sum())
        self.label_rms_request = max(self.label_rms_request, (square / diff.numel()) ** 0.5)
        self.label_logit_rms_request = max(self.label_logit_rms_request,
                                           (logit_sq / max(active, 1)) ** 0.5)
        masses = [torch.zeros((s.shape[0], self.labels), device=s.device).scatter_add_(
            1, lab.long(), s.float()) for s, lab in ((res['scores'], res['labels']),
                                                     (ref['scores'], ref['labels']))]
        self.mass_diff += float((masses[0] - masses[1]).abs().sum())
        self.mass += float(masses[1].sum())
        cover = ((res['segmentation'] >= 0) != ref['cover']).float().mean(dim=(1, 2))
        self.cover_gap = max(self.cover_gap, float(cover.amax()))
        (label, score), (ref_label, ref_score) = owners(res), owners(ref)
        differ = (label != ref_label) | ((score - ref_score).abs() > self.OWNER_SCORE)
        self.owner_diff += int(differ.sum())
        self.pixels += differ.numel()
        self.owner_tally = [a + c for a, c in zip(self.owner_tally, tally(ref['margin'][differ]))]

    def numbers(self) -> dict:
        return {'label_logit_rms_request': self.label_logit_rms_request,
                'label_rms_request': self.label_rms_request,
                'owner_far_share': far_share(self.owner_tally, self.pixels, 0.0, FAR),
                'owner_share': self.owner_diff / max(self.pixels, 1),
                'owner_tally': self.owner_tally,
                'score_gap': self.score_gap,
                'label_mass_all': self.mass_diff / max(self.mass, 1.0),
                'cover_gap': self.cover_gap}


def _leaf_gaps(prog: dict, ref: dict, names) -> tuple[float, float, str]:
    """(the worst leaf's gap, the median leaf's gap, the worst leaf)."""
    median = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], statistics.median(gaps.values()), worst


def share(flips: int, decisions: int, gap: float) -> float:
    """The share of followed decisions that differ from the reference's
    own; inf where they could not be followed."""
    return flips / decisions if decisions and math.isfinite(gap) else float('inf')


def far_share(counts: list, decisions: int, gap: float, margin: float) -> float:
    """The share of followed decisions that differ from the reference's
    own by more than ``margin`` (an edge of ``reference.model.MARGINS``)
    of its margin on them, from their tally; inf where they could not be
    followed."""
    far = sum(counts[MARGINS.index(margin) + 1:])
    return far / decisions if decisions and math.isfinite(gap) else float('inf')


def train_gaps(prog: dict, ref: dict) -> tuple[dict, dict]:
    """``prog`` and ``ref`` each hold ``losses`` (the first micro-steps'),
    ``grad`` and ``change`` ({leaf: norm}); a leaf the program lacks reads
    as a norm of 0. Returns (the numbers, the leaf that set each leaf
    number)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog['losses'], ref['losses'])]
    names = sorted(ref['grad'])
    grad, grad_median, grad_at = _leaf_gaps(prog['grad'], ref['grad'], names)
    median = statistics.median(ref['grad'][n] for n in names)
    moving = [n for n in names if ref['grad'][n] >= STILL * median]
    change, change_median, change_at = _leaf_gaps(prog['change'], ref['change'], moving)
    return ({'loss_gap': max(losses), 'first_loss_gap': losses[0], 'grad_gap': grad,
             'grad_median_gap': grad_median, 'change_gap': change,
             'change_median_gap': change_median, 'match_gap': ref.get('match_gap', 0.0),
             'match_mean_gap': (statistics.fmean(ref['match_excess'])
                                if ref.get('match_excess') else float('inf')),
             'point_gap': ref.get('point_gap', 0.0), 'mask_gap': ref.get('mask_gap', 0.0),
             'point_flip_share': share(ref.get('point_flips', 0), ref.get('point_decisions', 0),
                                       ref.get('point_gap', 0.0)),
             'mask_flip_share': share(ref.get('mask_flips', 0), ref.get('mask_decisions', 0),
                                      ref.get('mask_gap', 0.0)),
             'point_far_share': far_share(ref.get('point_tally', [0]), ref.get(
                 'point_decisions', 0), ref.get('point_gap', 0.0), FAR),
             'mask_far_share': far_share(ref.get('mask_tally', [0]), ref.get(
                 'mask_decisions', 0), ref.get('mask_gap', 0.0), FAR),
             'point_tally': ref.get('point_tally'), 'mask_tally': ref.get('mask_tally')},
            {'grad_gap_leaf': grad_at, 'change_gap_leaf': change_at,
             'still_leaves': ' '.join(n for n in names if n not in moving)})
