"""The RWKV6 recurrence: the token recurrence (kernel B6, ``kernel.py``)
and the same function in chunks of 32 tokens (kernel B7,
``kernel_chunked.py``), their plain versions (``ref.py``) and public ops
(``ops.py``)."""
