"""Cell plans traced on meta tensors over a fake production mesh: the
mesh (``mesh``), the cells' inputs (``specs``), the counters and roofline
terms (``roofline``), the per-cell measurement (``measure``), the dry-run
and hill-climb command lines (``dryrun``, ``hillclimb``)."""
