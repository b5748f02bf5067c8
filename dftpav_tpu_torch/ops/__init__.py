"""Kernel-layout objective (kcost), the batched solve (pallas_solve), the
coefficient helpers (bcost) and the CUDA build and binding (_cuda).
Module names follow dftpav_tpu.ops so each counterpart is easy to find."""
