"""Slack notifications connector (parity: python/pathway/io/slack —
``send_alerts`` posting row messages to a channel).

Posts through the documented ``chat.postMessage`` REST endpoint over
``http.client`` — no client library needed.
"""

from __future__ import annotations

import http.client
import json as _json
import threading
from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils

__all__ = ["send_alerts"]


class _SlackSink:
    def __init__(self, channel: str, token: str, host: str = "slack.com"):
        self.channel = channel
        self.token = token
        self.host = host
        self._pending: list[str] = []
        self._lock = threading.Lock()

    def add(self, text: str) -> None:
        with self._lock:
            self._pending.append(text)

    MAX_ATTEMPTS = 5

    def _post_once(self, text: str) -> tuple[bool, float, str]:
        """(posted, retry_after_s, error) — retryable failures return
        posted=False instead of raising."""
        conn = http.client.HTTPSConnection(self.host, timeout=30)
        try:
            conn.request(
                "POST",
                "/api/chat.postMessage",
                body=_json.dumps({"channel": self.channel, "text": text}).encode(),
                headers={
                    "Content-Type": "application/json; charset=utf-8",
                    "Authorization": f"Bearer {self.token}",
                },
            )
            resp = conn.getresponse()
            raw = resp.read()
            try:
                payload = _json.loads(raw or b"{}")
            except ValueError:
                payload = {}
            if resp.status < 300 and payload.get("ok", False):
                return True, 0.0, ""
            err = str(payload.get("error", resp.status))
            # rate limits and server errors are routine for an alert burst
            # (chat.postMessage allows ~1 msg/s) — retry, don't kill the
            # monitoring pipeline
            if resp.status == 429 or err == "ratelimited" or resp.status >= 500:
                retry_after = float(resp.headers.get("Retry-After", 1.0) or 1.0)
                return False, retry_after, err
            raise RuntimeError(f"slack postMessage failed: {err}")
        finally:
            conn.close()

    def flush(self, _time: int | None = None) -> None:
        import time as _t

        while True:
            with self._lock:
                if not self._pending:
                    return
                text = self._pending[0]
            last_err = ""
            for attempt in range(self.MAX_ATTEMPTS):
                posted, retry_after, last_err = self._post_once(text)
                if posted:
                    break
                if attempt < self.MAX_ATTEMPTS - 1:  # no sleep before raising
                    _t.sleep(min(retry_after * (attempt + 1), 30.0))
            else:
                raise RuntimeError(
                    f"slack postMessage failed after {self.MAX_ATTEMPTS} "
                    f"attempts: {last_err}"
                )
            # drain only after the message durably posted
            with self._lock:
                self._pending.pop(0)


def send_alerts(
    alerts: Table,
    slack_channel_id: str,
    slack_token: str,
    *,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Post each new row's first column as a message to a Slack channel.

    Reference: ``pw.io.slack.send_alerts`` (python/pathway/io/slack).
    """
    names = alerts.column_names()
    sink = (_sink_factory or _SlackSink)(slack_channel_id, slack_token)

    def on_data(key, row, time, diff):
        if diff <= 0:
            return  # alerts are append-only; retractions are not re-posted
        if len(names) == 1 and isinstance(row[0], str):
            text = row[0]
        else:
            text = _json.dumps(
                {n: _utils.plain_value(v) for n, v in zip(names, row)}
            )
        sink.add(text)

    _utils.register_output(
        alerts,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.flush,
        name=name or f"slack:{slack_channel_id}",
    )
