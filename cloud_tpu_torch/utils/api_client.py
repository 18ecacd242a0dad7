"""HTTP plumbing for GCP REST calls, with usage telemetry and injectable auth.

The port's copy of ``cloud_tpu/utils/api_client.py``; ``requests`` and
``google.auth`` stay deferred imports (a card host may have neither).

Reference analogue: ``utils/google_api_client.py:21-39`` (TFCloudHttpRequest
stamps ``user-agent: tf-cloud/<ver>`` on every googleapiclient call).  The
googleapiclient stack is replaced by a thin :mod:`requests` session; every
network seam in this framework accepts a session-like object so tests inject
fakes (SURVEY.md §4 takeaway (b)).

Failure typing is part of the wire contract: a non-2xx response raises
:class:`ApiError`, and the *retryable* subset — 429, 5xx, and transport
failures (connection reset, timeout) that previously escaped as raw
``requests`` exceptions — raises :class:`ApiTransientError` instead, so
callers classify by type rather than by string.  The session itself
absorbs short blips through a :class:`~cloud_tpu_torch.utils.retries.RetryPolicy`
(jittered exponential backoff, ``Retry-After`` honored); permanent 4xx
still fails on the first attempt.  Pass ``retry=None`` for the raw
single-attempt behavior (tests that script exact wire sequences).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from cloud_tpu_torch.utils import faults
from cloud_tpu_torch.version import __version__

USER_AGENT = f"cloud-tpu/{__version__}"


class ApiError(RuntimeError):
    """Non-2xx response from a GCP API."""

    def __init__(self, status: int, message: str, body: Optional[dict] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.body = body or {}


class ApiTransientError(ApiError):
    """A retryable failure: 429/5xx, or a transport error (status 0).

    ``retry_after`` carries the server's ``Retry-After`` hint in seconds
    when one was sent; the retry layer treats it as a floor under its
    own backoff.
    """

    def __init__(self, status: int, message: str,
                 body: Optional[dict] = None,
                 retry_after: Optional[float] = None):
        super().__init__(status, message, body)
        self.retry_after = retry_after


def _retry_after_seconds(resp) -> Optional[float]:
    """Parse a Retry-After header (delta-seconds form only — HTTP-date
    is legal but GCP sends seconds)."""
    try:
        raw = resp.headers.get("Retry-After")
    except Exception:  # noqa: BLE001 — fakes without headers
        return None
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


class GcpApiSession:
    """Minimal authenticated JSON-over-REST session.

    ``credentials`` anything with a ``token`` attribute and a
    ``refresh(request)`` method (google.auth credentials), or None for
    anonymous (tests).  The object is deliberately tiny so fakes are
    trivial.  ``retry`` is the transient-failure policy (default: the
    session-grade :func:`retries.default_api_policy`); pass ``None`` to
    disable in-session retries.
    """

    def __init__(self, credentials=None, requests_session=None,
                 retry="default"):
        self._credentials = credentials
        if requests_session is None:
            import requests

            requests_session = requests.Session()
        self._session = requests_session
        if retry == "default":
            from cloud_tpu_torch.utils import retries

            retry = retries.default_api_policy()
        self._retry = retry

    def _headers(self) -> Dict[str, str]:
        headers = {"user-agent": USER_AGENT, "content-type": "application/json"}
        if self._credentials is not None:
            if not getattr(self._credentials, "valid", False):
                import google.auth.transport.requests

                self._credentials.refresh(
                    google.auth.transport.requests.Request(session=self._session)
                )
            headers["authorization"] = f"Bearer {self._credentials.token}"
        return headers

    def request(
        self,
        method: str,
        url: str,
        body: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, str]] = None,
    ) -> Dict[str, Any]:
        if self._retry is None:
            return self._request_once(method, url, body, params)
        idempotent = method.upper() in ("GET", "PUT", "DELETE")

        def classify(exc: BaseException) -> bool:
            if not self._retry.classify(exc):
                return False
            if not idempotent and getattr(exc, "status", None) == 0:
                # Ambiguous transport failure on a non-idempotent POST:
                # the request may have reached the server, and a blind
                # re-send could duplicate it (a second Cloud Build, a
                # double-completed vizier trial).  Surface it; callers
                # with an idempotence story (deploy's node-create 409
                # tolerance) retry at their own layer.  A 429/5xx
                # RESPONSE stays retryable — the server answered.
                return False
            return True

        return self._retry.call(
            lambda: self._request_once(method, url, body, params),
            name="api_request", classify=classify,
        )

    def _request_once(self, method, url, body, params) -> Dict[str, Any]:
        # Chaos seam: an injected plan can fail/hang this exact point —
        # the same place real 503s and connection resets surface.
        faults.fault_point("api.request")
        try:
            resp = self._session.request(
                method,
                url,
                headers=self._headers(),
                params=params,
                data=None if body is None else json.dumps(body),
            )
        except OSError as exc:
            # requests.RequestException subclasses IOError, so one clause
            # covers ConnectionError/Timeout from requests AND the
            # builtin socket-level classes — all transient by nature.
            raise ApiTransientError(
                0, f"transport error calling {method} {url}: {exc!r}"
            ) from exc
        if resp.status_code >= 300:
            try:
                parsed = resp.json()
            except Exception:
                parsed = {}
            if resp.status_code == 429 or resp.status_code >= 500:
                raise ApiTransientError(
                    resp.status_code, resp.text[:500], parsed,
                    retry_after=_retry_after_seconds(resp),
                )
            raise ApiError(resp.status_code, resp.text[:500], parsed)
        if not resp.content:
            return {}
        return resp.json()

    def get(self, url, params=None):
        return self.request("GET", url, params=params)

    def post(self, url, body=None, params=None):
        return self.request("POST", url, body=body, params=params)

    def delete(self, url):
        return self.request("DELETE", url)


def default_session() -> GcpApiSession:
    """Session with application-default credentials."""
    import google.auth

    credentials, _ = google.auth.default(
        scopes=["https://www.googleapis.com/auth/cloud-platform"]
    )
    return GcpApiSession(credentials=credentials)
