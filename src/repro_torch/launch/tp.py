"""The model axis of a mesh for activations: tensor, sequence and expert
parallelism written out by hand.

The reference leaves the model axis to XLA's partitioner: its rules
(`launch/sharding.py::axis_rules`) put heads, the MLP's hidden dim, the
vocabulary and the experts over 'model', and `shard_batch_seq` splits
the residual stream's sequence over 'model' between blocks (sequence
parallelism, the reference's `seq_parallel=True`). The port runs one
process a rank, so, as `launch/fsdp.py` does for the data axis, the
collectives are written out here, each a `torch.autograd.Function`
through `rp.shard`'s ledger under its own tag:

* `ModelAxis.enter`: the input of a column-parallel product (`wq`, `wk`,
  `wv`, `w_gate`, `w_up`, the experts, the untied unembedding). Under
  sequence parallelism the rank's sequence rows are all-gathered (tag
  `tp_gather`), and the backward reduce-scatters the ranks' partial
  gradients back onto the rows; without it the stream is whole on every
  rank, and the backward all-reduces (tag `tp_grad`).
* `ModelAxis.leave`: the output of a row-parallel product (`wo`,
  `w_down`, the expert combine), a partial sum on each rank, reduced in
  float32 (tag `tp_reduce`): under sequence parallelism one
  reduce-scatter onto the rank's rows, without it an all_reduce. The
  backward all-gathers the rows' gradient, or passes it through. (The
  reference's `sp_block_outputs` chooses where XLA places that
  constraint; a collective written by hand has one place, and the
  reduce-scatter moves half an all_reduce's bytes for the same sums.)
* `ModelAxis.gather_cols`: the embedding's lookup on the rank's columns
  (`embed_tp`) all-gathered to whole rows (tag `tp_embed`); the backward
  takes the rank's columns of the gradient, which every model rank holds
  whole.
* `ModelAxis.split`: the rank's sequence rows of a tensor every model
  rank holds whole (the embedded stream before the first block); the
  backward all-gathers the rows' gradient (tag `tp_grad`).
* `ModelAxis.cols`: the rank's contiguous column block of a product's
  output all-gathered along the last dim (tag `tp_cols`; mamba2's
  `in_proj`, whose blocks are not the rank's heads); the backward
  reduce-scatters the ranks' partial gradients back onto the blocks.
* `ModelAxis.stat`: the all_reduce of a statistic each rank takes over
  its own channels and then uses on them alone (the sum of squares of
  mamba2's gated RMSNorm over the whole `d_in`; tag `tp_stat`). Its
  backward all-reduces too: each rank's gradient of the sum covers only
  its own channels' uses of it. (`_Reduce`'s pass-through backward is
  right for a stream every rank then uses whole, and wrong here.)
* `ModelAxis.scatter`: partial sums reduce-scattered along a dim onto the
  rank's block (the RG-LRU's gate products, row-split with whole
  columns, onto the rank's channels; tag `tp_gate`).

A part whose leaves the reference's `spec_for` replicates (a dim the
model size does not divide: llama3.2-3b's d_ff of 8192 on 3 ranks,
mamba2-1.3b's 8512 `in_proj` columns) runs whole on every model rank
(`ModelAxis.parts`, each family's `split_parts`; a leaf of it the specs
do split is read whole, `fsdp.Sharded(whole=True)`). Under sequence
parallelism `ModelAxis.whole_in` all-gathers its input's rows (tag
`tp_whole`; the backward reduce-scatters, so each row's gradient is
summed once) and `ModelAxis.whole_out` keeps the rank's rows of its
output: nothing is reduced, and its weights' gradients are each rank's
share of its own rows, summed over 'model' with the other replicated
leaves' (`fsdp.Sharded.finish`). Without it the stream is whole and
alike on every rank: the part's output leaves as it is, and its weights'
gradients are whole already (summed, they would count model-size
times).

A model axis that does not divide the query heads but does divide their
columns (llama3.2-3b's 24, or qwen2-vl-2b's 12, on the production
mesh's 16) keeps the reference's layout, which splits `wq` into equal
blocks of Hq*hd/ms columns and `wo` into as many rows: a block holds
part of a head (`ModelAxis.head_split`, set by
`transformer._model_axis` for the decoder and hybrid families).
The rank's block of q is all-gathered to every head (`cols`, tag
`tp_heads`), the rank attends with the heads its block of `wo`'s rows
reads (at most two more than the block's share: the heads at its two
ends, which the neighbouring ranks attend too), and takes its columns of
their output into the row-parallel product. The KV heads then never
divide either, so `wk`/`wv` are read whole.

Convention: a tensor the model ranks hold alike carries the same whole
gradient on each of them (the Megatron convention); a product's partial
sum is reduced where it leaves the parallel region. The gradients of the
leaves the model axis does not split are then each rank's partial sum
over its own rows under sequence parallelism, summed over 'model' by
`fsdp.Sharded.finish` (tag `grad_model`), and alike on every rank
without it.

The loss: `vocab_parallel_nll` is the untied unembedding's cross-entropy
over a vocabulary split over 'model' (each rank's V/ms block of logits for
every gathered row): the row max and the sum of exponentials are
all-reduced a chunk at a time (tag `tp_ce`), the label's logit comes from
the rank that holds it. Every model rank then holds the same loss, and
`ModelAxis.once` counts it once in the sum over ranks. The tied
embedding's unembedding is split on D, not on V, so the loss gathers the
embedding's model blocks instead (`fsdp.Sharded(whole=True)`, tag
`model_gather`: V*D elements a step, 1.58 GB fp32 at llama3.2-3b) and
takes the cross-entropy of the rank's own rows.
"""
from __future__ import annotations

import torch

from repro_torch.rp import shard


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; the backward reduce-scatters (partial
    gradients) or takes the rank's block (gradients alike on every
    rank)."""

    @staticmethod
    def forward(ctx, x, group, dim, tag, backward):
        ctx.meta = (group, dim, backward)
        return shard.all_gather_dim(x, group, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        group, dim, backward = ctx.meta
        if backward == "scatter":
            g = shard.reduce_scatter(g, group, dim, tag="tp_grad")
        else:
            per = g.shape[dim] // group.size
            g = g.narrow(dim, group.index * per, per)
        return g, None, None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter of partial sums along `dim` (tag `tag`); the
    backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.meta = (group, dim)
        return shard.reduce_scatter(x, group, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.meta
        return (shard.all_gather_dim(g, group, dim, tag="tp_grad"), None,
                None, None)


class _Reduce(torch.autograd.Function):
    """All-reduce of partial sums; the backward passes the (whole, alike)
    gradient through."""

    @staticmethod
    def forward(ctx, x, group, tag):
        return shard.all_reduce(x, group, tag=tag).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Stat(torch.autograd.Function):
    """All-reduce of a statistic each rank takes over its own channels
    and uses on them alone; the backward all-reduces the ranks' partial
    gradients of it."""

    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.meta = (group, tag)
        return shard.all_reduce(x, group, tag=tag).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        group, tag = ctx.meta
        return shard.all_reduce(g, group, tag=tag).to(g.dtype), None, None


class _Copy(torch.autograd.Function):
    """The identity into a parallel region; the backward all-reduces the
    ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return shard.all_reduce(g, ctx.group, tag="tp_grad"), None


class _Split(torch.autograd.Function):
    """The rank's block along `dim` of a tensor every rank holds alike;
    the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.meta = (group, dim)
        per = x.shape[dim] // group.size
        return x.narrow(dim, group.index * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.meta
        return (shard.all_gather_dim(g, group, dim, tag="tp_grad"), None,
                None)


class _Once(torch.autograd.Function):
    """A scalar every model rank holds alike, as its 1/ms share of the sum
    over the ranks. The backward passes the gradient through unscaled:
    the sum's gradient reaches each rank's copy through the other ranks'
    copies too (the collectives inside it, whose backward is written by
    hand for the quantity itself), ms shares of 1/ms."""

    @staticmethod
    def forward(ctx, x, size):
        return x / size

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelAxis:
    """The model axis of `mesh` as the forward sees it: `size` ranks, this
    one at `index`. `seq_parallel` splits the residual stream's sequence
    over the ranks between the parallel regions (a sequence the size
    does not divide runs without it, as the reference's `shard_batch_seq`
    leaves such a sequence whole). The settings' `gqa_expand` and
    `moe_c_shard` are read once, when the axis is made
    (`from_settings`), so a block recomputed in the backward pass takes
    what its forward took."""

    def __init__(self, mesh, *, seq_parallel: bool = True,
                 gqa_expand: bool = False, moe_c_shard: bool = False):
        self.mesh = mesh
        self.group = mesh.group("model")
        self.size = self.group.size
        self.index = self.group.index
        self.seq_parallel = seq_parallel
        self.gqa_expand = gqa_expand
        self.moe_c_shard = moe_c_shard
        # (lo, hi, off, width) where the axis splits inside a head: the
        # query heads [lo, hi) the rank's `width` rows of wo read, and the
        # offset of those rows in their (hi - lo) heads' output
        self.head_split = None
        # part -> whether it runs split (its family's `split_parts`)
        self.parts: dict[str, bool] = {}

    def runs_split(self, part: str) -> bool:
        """Whether the family's `part` runs split over the axis (else
        whole on every rank)."""
        return self.parts.get(part, False)

    def split_heads(self, n_heads: int, hd: int) -> None:
        """Mark the axis as splitting `n_heads` heads of `hd` inside a
        head: the rank's rows of wo are [index w, (index + 1) w), w =
        n_heads hd / size."""
        width = n_heads * hd // self.size
        a = self.index * width
        lo, hi = a // hd, (a + width - 1) // hd + 1
        self.head_split = (lo, hi, a - lo * hd, width)

    def rank_heads(self, q: torch.Tensor) -> torch.Tensor:
        """The query heads (dim 2) the rank attends with: its own block of
        q's heads as the forward made it, or under `head_split` (q every
        head) the heads its rows of wo read."""
        if self.head_split is None:
            return q
        lo, hi = self.head_split[:2]
        return q[:, :, lo:hi]

    def head_cols(self, attn: torch.Tensor) -> torch.Tensor:
        """The rank's columns (..., width) of the attention output (...,
        (hi - lo) hd) of `rank_heads`, which its rows of wo take; the
        output as it is without `head_split`."""
        if self.head_split is None:
            return attn
        off, width = self.head_split[2:]
        return attn.narrow(-1, off, width)

    @classmethod
    def from_settings(cls, *, seq_parallel: bool = False):
        """The axis of `models.settings`' mesh, or None: no mesh, or a
        model axis of 1."""
        from repro_torch.models import settings
        st = settings.get()
        mesh = st.mesh
        if mesh is None or mesh.shape.get("model", 1) <= 1:
            return None
        return cls(mesh, seq_parallel=seq_parallel,
                   gqa_expand=st.gqa_expand, moe_c_shard=st.moe_c_shard)

    def sp(self, seq_len: int) -> bool:
        """Whether a sequence of `seq_len` runs sequence-parallel."""
        return self.seq_parallel and seq_len % self.size == 0

    def enter(self, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """The input (B, S_local, D) of a column-parallel product as the
        whole sequence (B, S, D)."""
        if sp:
            return _Gather.apply(x, self.group, 1, "tp_gather", "scatter")
        return _Copy.apply(x, self.group)

    def leave(self, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """A row-parallel product's partial sums (B, S, D) reduced: the
        rank's rows under sequence parallelism, else the whole."""
        if not sp:
            return _Reduce.apply(x, self.group, "tp_reduce")
        return _Scatter.apply(x, self.group, 1, "tp_reduce")

    def whole_in(self, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """The input of a part that runs whole on every rank: under
        sequence parallelism the rank's rows (B, S_local, ...)
        all-gathered to the whole sequence (tag `tp_whole`; the backward
        reduce-scatters), else x as it is."""
        if sp:
            return _Gather.apply(x, self.group, 1, "tp_whole", "scatter")
        return x

    def whole_out(self, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """The output (B, S, ...) of a part that ran whole: the rank's
        rows under sequence parallelism (`own_rows`), else x as it is."""
        return self.own_rows(x) if sp else x

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of dim 1 of a tensor every rank holds, sliced:
        the backward leaves the other rows' gradient zero, so what was
        read to make x gets the rank's own rows' share (`split`'s
        backward gathers every row's instead)."""
        per = x.shape[1] // self.size
        return x.narrow(1, self.index * per, per)

    def scatter(self, x: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
        """Partial sums reduce-scattered along `dim` onto the rank's
        block; the backward all-gathers."""
        return _Scatter.apply(x, self.group, dim, tag)

    def cols(self, x: torch.Tensor, tag: str = "tp_cols") -> torch.Tensor:
        """The rank's contiguous column block (..., N/ms) of a product's
        output all-gathered to (..., N); the backward reduce-scatters the
        ranks' partial gradients onto the blocks."""
        return _Gather.apply(x, self.group, x.ndim - 1, tag, "scatter")

    def stat(self, x: torch.Tensor, tag: str = "tp_stat") -> torch.Tensor:
        """The sum over the ranks of a statistic of each rank's own
        channels, which each rank then uses on its channels alone; the
        backward all-reduces (see `_Stat`)."""
        return _Stat.apply(x, self.group, tag)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's columns (..., D/ms) of rows every rank looked up
        alike, all-gathered to (..., D)."""
        return _Gather.apply(x, self.group, x.ndim - 1, "tp_embed", "slice")

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's block along `dim` of a tensor every rank holds
        alike."""
        return _Split.apply(x, self.group, dim)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar every rank holds alike, counted once in the sum over
        the model ranks (see `_Once`)."""
        return _Once.apply(x, self.size)

    def all_reduce(self, x: torch.Tensor, *, op: str = "sum",
                   tag: str = "tp_reduce") -> torch.Tensor:
        """A plain all_reduce over the axis (no gradient): inference."""
        return shard.all_reduce(x, self.group, op=op, tag=tag)

    def all_gather(self, x: torch.Tensor, dim: int,
                   tag: str = "tp_gather") -> torch.Tensor:
        """A plain all_gather along `dim` over the axis (no gradient)."""
        return shard.all_gather_dim(x, self.group, dim, tag=tag)


class _VocabNLL(torch.autograd.Function):
    """The cross-entropy of logits split over the vocabulary: this rank's
    (N, V/ms) block, starting at vocabulary index `lo`; labels (N,).
    Returns the (N,) negative log-likelihoods, alike on every rank. The
    backward of a row is softmax - onehot on the rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        n = logits.shape[-1]
        m = shard.all_reduce(logits.detach().amax(dim=-1), group, op="max",
                             tag="tp_ce")
        e = torch.exp(logits - m[:, None])
        se = shard.all_reduce(e.sum(dim=-1), group, tag="tp_ce")
        local = labels - lo
        mine = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[:, None]
        gold = torch.where(mine, torch.gather(logits, 1, idx)[:, 0], 0.0)
        gold = shard.all_reduce(gold, group, tag="tp_ce")
        ctx.save_for_backward(e, se, idx, mine)
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e / se[:, None]
        grad.scatter_add_(1, idx, -mine.to(grad.dtype)[:, None])
        return grad * g[:, None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                       axis: ModelAxis) -> torch.Tensor:
    """(N, V/ms) float32 logits of this rank's vocabulary block [lo, lo +
    V/ms) and (N,) labels -> (N,) negative log-likelihoods over the
    whole vocabulary (every rank alike)."""
    return _VocabNLL.apply(logits, labels, lo, axis.group)


__all__ = ["ModelAxis", "vocab_parallel_nll"]
