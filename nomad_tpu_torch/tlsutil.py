"""TLS context construction for the RPC tier and the uplink tunnel.

Port of nomad_tpu/tlsutil.py, unchanged in behaviour: the same
``TLSConfig`` gives contexts with the same options in both packages, so a
TLS peer of either talks to the other.

Reference: upstream nomad/tlsutil (IncomingTLSConfig/
OutgoingTLSConfig feeding the optional rpcTLS listener arm,
nomad/rpc.go:104-110) and command/agent config's `ca_file`/`cert_file`/
`key_file`. Same knob set here, expressed as stdlib ssl contexts:

- incoming (listener) context: serves the node certificate; with
  ``verify_incoming`` it requires and verifies peer certificates against
  the CA (mutual TLS — the reference's VerifyIncoming).
- outgoing (dial) context: verifies the server against the CA; with a
  client cert/key pair it also presents one (for mutual TLS peers). With
  ``verify_hostname`` off the certificate chain is still verified but the
  hostname is not — the reference's VerifyServerHostname=false default,
  which matches certificates shared by a whole region rather than minted
  per-host.

No TLS code path touches the wire format: contexts wrap the already-
accepted/connected TCP socket, so the framed-JSON mux above is unchanged.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


def _pin_full_duplex_safe(ctx: ssl.SSLContext) -> None:
    """Pin TLS 1.2 with renegotiation off.

    The mux transport (rpc.py) runs ONE blocking reader thread plus
    serialized writer threads on the same socket — full duplex. OpenSSL
    does not guarantee concurrent SSL_read/SSL_write on one SSL* when a
    read can trigger a write: TLS 1.3 processes KeyUpdate/session tickets
    inside SSL_read, and TLS 1.2 renegotiation does the same. Pinning 1.2
    AND disabling renegotiation means post-handshake reads never write
    and writes never read, making the one-reader/serialized-writers
    pattern sound."""
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.maximum_version = ssl.TLSVersion.TLSv1_2
    ctx.options |= ssl.OP_NO_RENEGOTIATION


@dataclass
class TLSConfig:
    """The agent-level TLS knob set (command/agent config analog)."""

    enabled: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    verify_incoming: bool = True
    verify_hostname: bool = False

    def incoming_context(self) -> Optional[ssl.SSLContext]:
        """Listener-side context, or None when TLS is disabled."""
        if not self.enabled:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        _pin_full_duplex_safe(ctx)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.verify_incoming:
            if not self.ca_file:
                raise ValueError(
                    "tls.verify_incoming requires tls.ca_file")
            ctx.load_verify_locations(self.ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def outgoing_context(self) -> Optional[ssl.SSLContext]:
        """Dial-side context, or None when TLS is disabled."""
        if not self.enabled:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        _pin_full_duplex_safe(ctx)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
        if self.cert_file and self.key_file:
            ctx.load_cert_chain(self.cert_file, self.key_file)
        if not self.verify_hostname:
            # Chain verification stays ON; only the hostname match is
            # relaxed (region-shared certificates).
            ctx.check_hostname = False
        return ctx
