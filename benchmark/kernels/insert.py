"""``csrc/insert.cu`` (``ops/insert.merge_rows``): the in-place merge of
each used bucket row's points into the map table. Bytes: each used row read
and written once (its 3 point planes and 5 aux planes) with its bucket id,
each live point read once (x, y, z, intensity, voxel), the counts in, the
per-row stats out, and the pose cells and window. No arithmetic is
counted: a slot merge does far fewer operations a byte than the card's
balance."""

from benchmark.roofline import nbytes

PROFILER = ("merge_rows_kernel",)


def work(args, kw, out):
    aux, slot_h, cnt, pvox = args[1], args[2], args[3], args[8]
    used = int((cnt > 0).sum())
    row = 8 * (aux.shape[-1] // 5) * 4
    n_pts = int(cnt.clamp(0, pvox.shape[-1]).sum())
    return (used * (2 * row + slot_h.element_size()) + n_pts * 5 * 4
            + 4 * cnt.numel() * cnt.element_size()
            + nbytes(list(args[9:11]))), 0


WRAPPERS = (("aloam_tpu_torch.ops.insert", "merge_rows", work),)
