"""Collective communication layer of the port: the executable collectives
of ``repro.ccl.primitives`` on ``torch.distributed`` (``primitives``) and
the synthesized-schedule types they interpret (``synth``)."""
