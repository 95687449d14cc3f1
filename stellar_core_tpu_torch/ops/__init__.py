"""Device ops of the port: plain torch tensor ops, and the hand-written
Hopper kernels for batched ed25519 verify (``ed25519_cuda``) and the live
SCP federated tally (``quorum_cuda``)."""
