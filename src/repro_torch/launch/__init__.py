"""Entry points of the port: `serve` (hedged LM serving) and `train`
(straggler-aware data-parallel training), with the step functions and
their sharding plans (`steps`), the assigned input shapes (`shapes`), the
meshes and the H100's constants (`mesh`), logical axes to DTensor
placements (`sharding`), and the multi-pod dry-run on a fake process
group with its byte profile and roofline (`dryrun`, `hlo_profile`,
`roofline`)."""
