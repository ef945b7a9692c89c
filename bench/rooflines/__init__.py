"""One file a kernel: the substrings of its symbol in a device trace
(``NAMES``), the peak it is held to (``DTYPE``) and ``work(cfg, call)``,
the operations and bytes its launches in one call need, counted from the
call's shapes whatever kernel implements them.  ``call`` is a prefill call
(``{"mode": "prefill", "B": .., "S": ..}``) or a decode step
(``{"mode": "decode", "B": .., "ctx": .., "slots": ..}``: ``ctx`` valid
slots of ``slots``)."""
