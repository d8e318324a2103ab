#!/usr/bin/env python3
"""Write the TEST-ONLY PKI that the port's TLS tests and ``chip_smoke.py``
read. Every key here is published with the repository: never trust these
certificates outside a test.

    python3 tests/torch_tls/make_pki.py      # rewrites the PEM files here

Files (PEM):

* ``ca.pem``: the test CA (``tpurpc TEST-ONLY CA``), which signs the two
  leaf certificates below;
* ``server.key`` / ``server.pem``: CN ``localhost``, SANs DNS ``localhost``
  and IP ``127.0.0.1``, for TLS server authentication;
* ``client.key`` / ``client.pem``: CN ``tpurpc-test-client``, SAN URI
  ``spiffe://tpurpc.test/client`` (the mTLS identity), for client
  authentication;
* ``other_ca.pem``: a second CA that signs nothing the servers use (the
  untrusted-server case).

Valid from 2025-01-01 to 2075-01-01, RSA 2048 with SHA-256. Needs the
``cryptography`` package; the tests themselves only read the files.
"""

import datetime
import ipaddress
import os

HERE = os.path.dirname(os.path.abspath(__file__))
NOT_BEFORE = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
NOT_AFTER = datetime.datetime(2075, 1, 1, tzinfo=datetime.timezone.utc)
CLIENT_URI = "spiffe://tpurpc.test/client"


def main() -> None:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    def key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    def name(cn):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    def unsigned(subject, issuer, pub):
        return (x509.CertificateBuilder()
                .subject_name(subject).issuer_name(issuer).public_key(pub)
                .serial_number(x509.random_serial_number())
                .not_valid_before(NOT_BEFORE).not_valid_after(NOT_AFTER))

    def ca(cn):
        k = key()
        cert = (unsigned(name(cn), name(cn), k.public_key())
                .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                               critical=True)
                .add_extension(x509.KeyUsage(
                    digital_signature=True, content_commitment=False,
                    key_encipherment=False, data_encipherment=False,
                    key_agreement=False, key_cert_sign=True, crl_sign=True,
                    encipher_only=False, decipher_only=False), critical=True)
                .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                    k.public_key()), critical=False)
                .sign(k, hashes.SHA256()))
        return k, cert

    def leaf(ca_key, ca_cert, cn, sans, usage):
        k = key()
        cert = (unsigned(name(cn), ca_cert.subject, k.public_key())
                .add_extension(x509.BasicConstraints(ca=False,
                                                     path_length=None),
                               critical=True)
                .add_extension(x509.SubjectAlternativeName(sans),
                               critical=False)
                .add_extension(x509.ExtendedKeyUsage([usage]), critical=False)
                .add_extension(
                    x509.AuthorityKeyIdentifier.from_issuer_public_key(
                        ca_key.public_key()), critical=False)
                .sign(ca_key, hashes.SHA256()))
        return k, cert

    def write(fname, data):
        with open(os.path.join(HERE, fname), "wb") as f:
            f.write(data)

    def key_pem(k):
        return k.private_bytes(serialization.Encoding.PEM,
                               serialization.PrivateFormat.TraditionalOpenSSL,
                               serialization.NoEncryption())

    def cert_pem(c):
        return c.public_bytes(serialization.Encoding.PEM)

    ca_key, ca_cert = ca("tpurpc TEST-ONLY CA")
    srv_key, srv_cert = leaf(
        ca_key, ca_cert, "localhost",
        [x509.DNSName("localhost"),
         x509.IPAddress(ipaddress.ip_address("127.0.0.1"))],
        ExtendedKeyUsageOID.SERVER_AUTH)
    cli_key, cli_cert = leaf(
        ca_key, ca_cert, "tpurpc-test-client",
        [x509.UniformResourceIdentifier(CLIENT_URI)],
        ExtendedKeyUsageOID.CLIENT_AUTH)
    _, other_cert = ca("tpurpc TEST-ONLY other CA")
    write("ca.pem", cert_pem(ca_cert))
    write("server.key", key_pem(srv_key))
    write("server.pem", cert_pem(srv_cert))
    write("client.key", key_pem(cli_key))
    write("client.pem", cert_pem(cli_cert))
    write("other_ca.pem", cert_pem(other_cert))


def load() -> dict:
    """The PEM files as bytes: ``ca``, ``srv_key``, ``srv_cert``,
    ``cli_key``, ``cli_cert``, ``other_ca``."""
    files = {"ca": "ca.pem", "srv_key": "server.key",
             "srv_cert": "server.pem", "cli_key": "client.key",
             "cli_cert": "client.pem", "other_ca": "other_ca.pem"}
    out = {}
    for k, fname in files.items():
        with open(os.path.join(HERE, fname), "rb") as f:
            out[k] = f.read()
    return out


if __name__ == "__main__":
    main()
