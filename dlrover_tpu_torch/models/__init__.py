"""Models of the port: TpuLM (``llama.py``), its KV-cache decoding
(``generate.py``) and param conversion from the reference
(``convert.py``)."""
