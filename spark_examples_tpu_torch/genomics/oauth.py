"""OAuth 2.0 credential exchange — the CredentialFactory analog.

The JAX package's ``genomics/oauth.py``.

The reference builds a user credential from client secrets through the
Google OAuth flow (``Client.scala:42``, google-genomics-utils
``CredentialFactory``) and Application Default Credentials otherwise
(``Client.scala:44``). This module implements the exchange leg both paths
share: the **refresh-token grant** (RFC 6749 §6) — a stored user
credential (client_id + client_secret + refresh_token, exactly the
``authorized_user`` shape ``gcloud`` writes for ADC) is exchanged at
``getAccessToken`` time against the token endpoint for a live access
token.

The authorization-code leg (the browser consent screen) mints the refresh
token once, interactively, outside the data path; a zero-egress
environment cannot reach a consent screen at all, so that leg stays out
of scope. The refresh leg is what every run exercises and what the
reference's ``OfflineAuth`` carries to workers.

The token endpoint is configurable (``token_uri`` in the credential
file): production files name the real endpoint; tests and self-hosted
deployments (``serve-cohort``) point it at their own.
"""

from __future__ import annotations

import json
from urllib.error import HTTPError, URLError
from urllib.parse import urlencode
from urllib.request import Request, urlopen

__all__ = ["GOOGLE_TOKEN_URI", "exchange_refresh_token"]

GOOGLE_TOKEN_URI = "https://oauth2.googleapis.com/token"


def exchange_refresh_token(
    client_id: str,
    client_secret: str,
    refresh_token: str,
    token_uri: str = GOOGLE_TOKEN_URI,
    timeout: float = 30.0,
    retry_policy=None,
) -> str:
    """POST the refresh-token grant; return the live access token.

    Raises :class:`~spark_examples_tpu_torch.genomics.auth.AuthError` with the
    endpoint's ``error``/``error_description`` on a denial — surfacing
    "invalid_grant: token revoked" beats a bare 400.

    The exchange runs under the shared retry engine with the OAUTH
    classification table (``resilience.classify_oauth``): transport
    trouble and 5xx/429 retry with backoff — the grant is idempotent —
    while 4xx denials (``invalid_grant`` & co, RFC 6749 §5.2) surface
    immediately: a revoked token never un-revokes, and hammering the
    token endpoint over one only invites throttling.
    """
    from spark_examples_tpu_torch.genomics.auth import AuthError
    from spark_examples_tpu_torch.resilience import (
        RetryPolicy,
        call_with_retry,
        classify_oauth,
        faults,
    )

    if retry_policy is None:
        retry_policy = RetryPolicy(max_attempts=3, base_delay=0.2)
    form = urlencode(
        {
            "grant_type": "refresh_token",
            "client_id": client_id,
            "client_secret": client_secret,
            "refresh_token": refresh_token,
        }
    ).encode()
    req = Request(
        token_uri,
        data=form,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
    )

    def attempt():
        faults.inject("transport.oauth.request", key=token_uri)
        with urlopen(req, timeout=timeout) as resp:
            return json.load(resp)

    try:
        payload = call_with_retry(
            attempt,
            retry_policy,
            classify_oauth,
            transport="oauth",
            method="token",
        )
    except faults.InjectedFault as e:
        raise AuthError(
            f"cannot reach token endpoint {token_uri}: {e}"
        ) from e
    except HTTPError as e:
        # OAuth error responses are JSON bodies on 4xx (RFC 6749 §5.2).
        try:
            detail = json.load(e)
        except (json.JSONDecodeError, OSError, ValueError):
            detail = {}
        raise AuthError(
            f"token exchange at {token_uri} failed ({e.code}): "
            f"{detail.get('error', 'unknown_error')}"
            + (
                f" — {detail['error_description']}"
                if detail.get("error_description")
                else ""
            )
        ) from e
    except (URLError, OSError) as e:
        raise AuthError(
            f"cannot reach token endpoint {token_uri}: {e}"
        ) from e
    except json.JSONDecodeError as e:
        raise AuthError(
            f"token endpoint {token_uri} returned malformed JSON: {e}"
        ) from e
    token = payload.get("access_token")
    if not token or not isinstance(token, str):
        raise AuthError(
            f"token endpoint {token_uri} returned no access_token"
        )
    return token
