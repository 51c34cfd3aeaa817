"""What each kind of configuration builds of the program: ``docstore``
(a ``DocumentStore`` with its embedder and index) and ``rag`` (the
Adaptive RAG answerer over such a store, served over REST)."""
