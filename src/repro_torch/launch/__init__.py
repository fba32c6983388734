"""Entry points of the port: `serve` (hedged LM serving) and `train`
(straggler-aware data-parallel training), with the step functions
(`steps`) and the assigned input shapes (`shapes`)."""
