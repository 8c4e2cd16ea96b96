"""How a cell's traffic drives the program: ``bulk`` (closed-loop calls
of ``BertTorch.encode_batch``) and ``serve`` (an open loop of text
requests to ``EmbeddingServer`` on the reference wire). Each module's
``run(cell)`` sets up, measures the window and returns what the run
learned."""
