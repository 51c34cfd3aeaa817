"""Prompt templates (parity: xpacks/llm/prompts.py).

A copy of ``pathway_tpu/xpacks/llm/prompts.py``: the same strings.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnExpression


def _docs_to_context(docs: Any) -> str:
    if isinstance(docs, Json):
        docs = docs.value
    parts = []
    for d in docs or ():
        if isinstance(d, Json):
            d = d.value
        if isinstance(d, dict):
            parts.append(str(d.get("text", d)))
        else:
            parts.append(str(d))
    return "\n\n".join(parts)


def prompt_short_qa(docs, query, additional_rules: str = "") -> ColumnExpression:
    r"""Build the short-answer QA prompt as a column expression.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.xpacks.llm import prompts
    >>> t = pw.debug.table_from_markdown('q\nwhat_is_a_tpu')
    >>> r = t.select(p=prompts.prompt_short_qa(pw.make_tuple('doc one'), pw.this.q))
    >>> out = pw.debug.table_to_pandas(r, include_id=False)
    >>> print('Answer the question' in out['p'][0], 'doc one' in out['p'][0])
    False True
    """
    def build(docs_v, query_v) -> str:
        return (
            "Please provide an answer based solely on the provided sources. "
            "Keep your answer concise and accurate. "
            + additional_rules
            + f"\nSources:\n{_docs_to_context(docs_v)}\nQuestion: {query_v}\nAnswer:"
        )

    return ApplyExpression(build, str, docs, query)


def prompt_qa(
    docs,
    query,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> ColumnExpression:
    def build(docs_v, query_v) -> str:
        return (
            "Please provide an answer based solely on the provided sources. "
            "When referencing information from a source, cite it. "
            f"If none of the sources are helpful, respond with: "
            f"{information_not_found_response} "
            + additional_rules
            + f"\nSources:\n{_docs_to_context(docs_v)}\nQuestion: {query_v}\nAnswer:"
        )

    return ApplyExpression(build, str, docs, query)


def prompt_qa_geometric_rag(
    docs,
    query,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> ColumnExpression:
    """The adaptive-RAG prompt (parity: prompts.py geometric rag prompt)."""

    def build(docs_v, query_v) -> str:
        context = _docs_to_context(docs_v)
        return (
            "Use the below articles to answer the subsequent question. If the "
            "answer cannot be found in the articles, write "
            f'"{information_not_found_response}" '
            + additional_rules
            + f"\nArticles:\n{context}\nQuestion: {query_v}\nAnswer:"
        )

    return ApplyExpression(build, str, docs, query)


def prompt_summarize(text_list) -> ColumnExpression:
    def build(texts) -> str:
        joined = "\n".join(str(t) for t in (texts or ()))
        return f"Summarize the following text concisely:\n{joined}\nSummary:"

    return ApplyExpression(build, str, text_list)


def prompt_query_rewrite_hyde(query) -> ColumnExpression:
    def build(q) -> str:
        return (
            "Write a short passage that would answer the question below "
            f"(hypothetical document embedding).\nQuestion: {q}\nPassage:"
        )

    return ApplyExpression(build, str, query)
