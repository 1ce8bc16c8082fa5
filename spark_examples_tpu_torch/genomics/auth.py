"""Authentication layer — Client.scala parity for network sources.

The JAX package's ``genomics/auth.py``.

The reference resolves credentials in two ways (``Client.scala:29-46``):

1. ``--client-secrets <file>``: builds a user credential — after printing a
   warning that the credential becomes visible to every worker and
   requiring an interactive ``Y/n`` confirmation on stdin
   (``Client.scala:32-41``);
2. otherwise Application Default Credentials.

Here the same surface exists for whatever Genomics-compatible service a
network source targets. Per SURVEY.md §2.1's note, the interactive prompt
must never block headless multi-host startup: confirmation is only
requested when the process is the coordinator AND stdin is a TTY;
non-interactive contexts fail closed with an instructive error instead of
hanging a pod.

Credential files come in two shapes, both on either path:

- ``{"token": ...}`` — a pre-exchanged access token, used as-is;
- ``{"client_id", "client_secret", "refresh_token"[, "token_uri"]}`` —
  a stored user credential (the ``authorized_user`` shape ``gcloud``
  writes for ADC, optionally nested under ``"installed"``), exchanged for
  a live access token via the OAuth refresh-token grant
  (:mod:`spark_examples_tpu_torch.genomics.oauth`) — the reference's
  ``CredentialFactory`` leg (``Client.scala:42``).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Optional

__all__ = ["Credentials", "get_access_token", "AuthError"]

# ADC-style environment variable (the "Application Default" path).
ADC_ENV = "GENOMICS_APPLICATION_CREDENTIALS"


class AuthError(RuntimeError):
    pass


@dataclass(frozen=True)
class Credentials:
    """An offline credential shippable to every ingest process — the
    ``OfflineAuth`` analog (serializable, no interactive state)."""

    token: str
    source: str  # "client-secrets" | "application-default" | "anonymous"


_WARNING = (
    "The Genomics API will be accessed using your user credentials; the "
    "credential will be visible to every process of this run. Only "
    "continue if that is acceptable. Continue? [Y/n] "
)


def _credential_shape(secrets: dict, path: str, origin: str) -> dict:
    """Validate the file's structure; → the flattened credential dict.

    Purely local (no network): callers on the interactive path run this
    BEFORE the confirmation prompt, so a structurally useless file is an
    AuthError up front — never a warning the user confirms only to watch
    it error, and never a misleading headless diagnostic about TTYs when
    the real problem is the file. Accepts the flat shape or Google's
    ``"installed"`` nesting.
    """
    flat = secrets.get("installed", secrets)
    if not isinstance(flat, dict):
        raise AuthError(f"{origin} {path}: 'installed' must be an object")
    if flat.get("token") or secrets.get("token"):
        return flat
    if all(
        flat.get(k)
        for k in ("client_id", "client_secret", "refresh_token")
    ):
        return flat
    raise AuthError(
        f"{origin} {path} has neither a 'token' entry nor a full "
        "refresh credential (client_id + client_secret + refresh_token); "
        "a client_id alone is public identity, not a secret — store an "
        "authorized_user credential or a pre-exchanged token"
    )


def _resolve_token(secrets: dict, flat: dict) -> str:
    """Validated credential → live access token (pre-exchanged or OAuth).

    An explicit ``token`` wins (already exchanged); otherwise the
    ``authorized_user`` triple runs the refresh-token grant against the
    file's ``token_uri`` (``Client.scala:42`` CredentialFactory leg).
    """
    token = flat.get("token") or secrets.get("token")
    if token:
        return token
    from spark_examples_tpu_torch.genomics.oauth import (
        GOOGLE_TOKEN_URI,
        exchange_refresh_token,
    )

    return exchange_refresh_token(
        flat["client_id"],
        flat["client_secret"],
        flat["refresh_token"],
        token_uri=flat.get("token_uri", GOOGLE_TOKEN_URI),
    )


def get_access_token(
    client_secrets_path: Optional[str] = None,
    interactive: Optional[bool] = None,
    _input=input,
) -> Credentials:
    """Resolve credentials — Authentication.getAccessToken semantics.

    Args:
      client_secrets_path: path to a JSON credential file (see module
        docstring for the two accepted shapes); triggers the visibility
        warning + confirmation, and any OAuth exchange happens only AFTER
        the user confirms (the reference also warns before building the
        credential, Client.scala:32-42).
      interactive: force/deny the confirmation prompt; default = stdin is
        a TTY (worker processes have none, so they fail closed).
    """
    if client_secrets_path:
        # Validate the file before prompting — a bad path/JSON is an
        # AuthError, not a post-confirmation traceback.
        try:
            with open(client_secrets_path) as f:
                secrets = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise AuthError(
                f"cannot read client secrets {client_secrets_path}: {e}"
            ) from e
        # Structural validation BEFORE the prompt (and before the
        # headless fail-closed check): a useless file must error as a
        # file problem, not a TTY problem. The OAuth exchange itself
        # still only happens after the user confirms.
        flat = _credential_shape(
            secrets, client_secrets_path, "client secrets"
        )
        if interactive is None:
            interactive = sys.stdin.isatty()
        if not interactive:
            raise AuthError(
                "client-secrets credentials need interactive confirmation "
                "(Client.scala:32-41 semantics); headless runs must use "
                f"application-default credentials (set {ADC_ENV})"
            )
        answer = _input(_WARNING).strip().lower()
        if answer not in ("", "y", "yes"):
            raise AuthError("user declined client-secrets credential")
        return Credentials(
            token=_resolve_token(secrets, flat), source="client-secrets"
        )

    adc = os.environ.get(ADC_ENV)
    if adc:
        # The variable must name a readable credential JSON file; an
        # explicitly configured credential silently degrading to
        # anonymous would be worse than failing. No confirmation on this
        # path — ADC is ambient by definition (Client.scala:44).
        try:
            with open(adc) as f:
                secrets = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise AuthError(f"cannot read {ADC_ENV}={adc}: {e}") from e
        flat = _credential_shape(secrets, adc, ADC_ENV)
        return Credentials(
            token=_resolve_token(secrets, flat),
            source="application-default",
        )
    return Credentials(token="", source="anonymous")
