"""Kernel-layout objective (kcost), the batched solve (pallas_solve), the
batch-minor objective and coefficient helpers (bcost), the batch-minor
L-BFGS (blbfgs), the corridor penalty (pallas_penalty) and the CUDA build
and binding (_cuda). Module names follow dftpav_tpu.ops so each counterpart
is easy to find."""
