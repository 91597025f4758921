"""A minimal LDAPv3 simple-bind client, the port's copy of
minio_tpu/utils/ldap.py: what AssumeRoleWithLDAPIdentity needs
(cmd/sts-handlers.go binds the user's DN against the directory; MinIO
uses go-ldap). Only the simple bind, over a plain socket.

Wire format (RFC 4511):
  LDAPMessage ::= SEQUENCE { messageID INTEGER,
                             protocolOp BindRequest/BindResponse }
  BindRequest  = [APPLICATION 0] { version INTEGER(3),
                                   name OCTET STRING,
                                   authentication [CONTEXT 0] password }
  BindResponse = [APPLICATION 1] { resultCode ENUMERATED, ... }
"""

from __future__ import annotations

import socket


class LDAPError(Exception):
    pass


# --- BER primitives (definite lengths only) ---

def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    while n:
        out.append(n & 0xFF)
        n >>= 8
    return bytes([0x80 | len(out)]) + bytes(reversed(out))


def _ber(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(payload)) + payload


def _ber_int(v: int) -> bytes:
    out = []
    while True:
        out.append(v & 0xFF)
        v >>= 8
        if v == 0 and not out[-1] & 0x80:
            break
    return _ber(0x02, bytes(reversed(out)))


def _parse_tlv(data: bytes, off: int) -> tuple[int, bytes, int]:
    """-> (tag, payload, next_offset)."""
    if off + 2 > len(data):
        raise LDAPError("short BER element")
    tag = data[off]
    l0 = data[off + 1]
    if l0 < 0x80:
        length, hdr = l0, 2
    else:
        nlen = l0 & 0x7F
        if nlen == 0 or off + 2 + nlen > len(data):
            raise LDAPError("bad BER length")
        length = int.from_bytes(data[off + 2:off + 2 + nlen], "big")
        hdr = 2 + nlen
    end = off + hdr + length
    if end > len(data):
        raise LDAPError("truncated BER element")
    return tag, data[off + hdr:end], end


def bind_request(message_id: int, dn: str, password: str) -> bytes:
    op = (
        _ber_int(3)                                  # version
        + _ber(0x04, dn.encode())                    # name
        + _ber(0x80, password.encode())              # simple auth
    )
    body = _ber_int(message_id) + _ber(0x60, op)     # [APPLICATION 0]
    return _ber(0x30, body)


def parse_bind_response(data: bytes) -> int:
    """-> LDAP resultCode (0 = success, 49 = invalidCredentials)."""
    tag, msg, _ = _parse_tlv(data, 0)
    if tag != 0x30:
        raise LDAPError("not an LDAPMessage")
    tag, _mid, off = _parse_tlv(msg, 0)
    if tag != 0x02:
        raise LDAPError("missing messageID")
    tag, op, _ = _parse_tlv(msg, off)
    if tag != 0x61:                                   # [APPLICATION 1]
        raise LDAPError(f"not a BindResponse (tag {tag:#x})")
    tag, code, _ = _parse_tlv(op, 0)
    if tag != 0x0A:                                   # ENUMERATED
        raise LDAPError("missing resultCode")
    return int.from_bytes(code, "big")


def simple_bind(server_addr: str, dn: str, password: str,
                timeout: float = 10.0) -> bool:
    """True when the directory accepts dn/password; False on
    invalidCredentials; raises LDAPError on protocol/transport faults.
    Anonymous binds (empty password) are always REJECTED client-side:
    RFC 4513 treats them as anonymous auth, which must never mint
    credentials (MinIO guards the same way)."""
    if not password:
        return False
    host, _, port = server_addr.partition(":")
    try:
        with socket.create_connection(
            (host, int(port or "389")), timeout=timeout
        ) as sock:
            sock.sendall(bind_request(1, dn, password))
            resp = sock.recv(4096)
    except OSError as exc:
        raise LDAPError(f"ldap server unreachable: {exc}") from exc
    if not resp:
        raise LDAPError("empty bind response")
    return parse_bind_response(resp) == 0
