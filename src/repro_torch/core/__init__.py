"""Engine, policy chain, λ-sync, schedulers and the PRNG of the port."""
