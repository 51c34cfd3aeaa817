"""xpacks of the port: the LLM toolkit's retrieval half (``llm``)."""
