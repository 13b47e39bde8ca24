"""The configurations' plain references, in plain PyTorch and float64.

They import nothing of the program and take nothing it made: the phase
bank, the positions and the counts are worked out here from the
configuration, the seed's inputs and the C reference's semantics
(dbry/audio-resampler, resampler.c).  ``control=True`` computes the same
outputs as a TF32 tensor core would (operands rounded to TF32, products
summed in float32): the precision below the float32 that the
configurations state, which the check has to refuse."""
