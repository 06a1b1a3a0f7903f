"""``jepsen_tpu_torch.serve`` — streaming check sessions.

- :mod:`.session` — the session engines: the register family's carried
  frontier on the card (:class:`~.session.DeviceFrontierEngine`) and
  the transactional incremental closure
  (:class:`~.session.TxnSessionEngine`).

The reference's checking daemon above them (sessions, their registry,
the HTTP protocol, the journal) is not ported yet (``ROADMAP.md``, Queue
1 item 3).
"""
