"""evaluator_ms: device ms a query of the kernels launched inside the
single-job evaluator, `cell_tc` (the draws, the running minimum,
`_masked_cells` or `lowered_eval_cells`), where the frontier binds it."""

LAYER = "evaluator"
WRAPS = (("repro_torch.fleet.vector", "cell_tc"),)


def read(view):
    return view.layer_ms(LAYER)
