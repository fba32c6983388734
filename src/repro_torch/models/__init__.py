"""The LM model stack, ported: shared numerics (`common`), MLPs,
grouped-query attention, the Mamba2 SSD block and the decoder-only model
assembly (`lm`: dense, ssm and hybrid families)."""
