"""mailauth tools parity: domain alignment, Authentication-Results rows.

Host-side helpers mirroring the reference's vendored mailauth tools
(packages/helpers/src/lib/mailauth/tools.ts:380-511): `getAlignment` (psl
org-domain matching), `formatAuthHeaderRow` + the two escape helpers, and
`validateAlgorithm`. The reference pulls the full Mozilla public-suffix list
via the `psl` npm package; this build is hermetic (zero egress), so
`psl_get` embeds the common multi-label public suffixes — enough for the
reference's bundled fixtures and typical mail domains — and falls back to
the standard single-label rule. A copy of the JAX package's module, so that
the port imports nothing of it.
"""

from __future__ import annotations

import re

# Multi-label public suffixes (subset of the PSL): for "a.b.suffix" the
# registrable (org) domain is "b.suffix". Single-label TLDs need no entry —
# the default rule (org domain = last two labels) covers them.
_MULTI_LABEL_SUFFIXES = {
    # United Kingdom / Ireland / Commonwealth
    "co.uk", "org.uk", "me.uk", "ltd.uk", "plc.uk", "net.uk", "sch.uk",
    "ac.uk", "gov.uk", "nhs.uk", "police.uk",
    # Australia / New Zealand
    "com.au", "net.au", "org.au", "edu.au", "gov.au", "asn.au", "id.au",
    "co.nz", "net.nz", "org.nz", "govt.nz", "ac.nz", "school.nz",
    # Japan / Korea / China / Taiwan / Hong Kong / Singapore / India
    "co.jp", "ne.jp", "or.jp", "go.jp", "ac.jp", "ad.jp", "ed.jp", "gr.jp",
    "co.kr", "ne.kr", "or.kr", "go.kr", "ac.kr", "re.kr",
    "com.cn", "net.cn", "org.cn", "gov.cn", "edu.cn", "ac.cn",
    "com.tw", "net.tw", "org.tw", "edu.tw", "gov.tw", "idv.tw",
    "com.hk", "net.hk", "org.hk", "edu.hk", "gov.hk", "idv.hk",
    "com.sg", "net.sg", "org.sg", "edu.sg", "gov.sg", "per.sg",
    "co.in", "net.in", "org.in", "firm.in", "gen.in", "ind.in", "ac.in",
    "edu.in", "res.in", "gov.in", "nic.in",
    # Americas
    "com.br", "net.br", "org.br", "gov.br", "edu.br",
    "com.mx", "net.mx", "org.mx", "gob.mx", "edu.mx",
    "com.ar", "net.ar", "org.ar", "gob.ar", "edu.ar",
    "com.co", "net.co", "org.co", "edu.co", "gov.co",
    "co.ve", "com.ve", "net.ve", "org.ve",
    # Europe / Africa / Middle East
    "co.za", "net.za", "org.za", "web.za", "gov.za", "ac.za",
    "co.il", "net.il", "org.il", "ac.il", "gov.il", "muni.il",
    "com.tr", "net.tr", "org.tr", "gov.tr", "edu.tr",
    "com.pl", "net.pl", "org.pl", "edu.pl", "gov.pl",
    "com.ru", "net.ru", "org.ru", "msk.ru", "spb.ru",
    "com.ua", "net.ua", "org.ua", "edu.ua", "gov.ua", "in.ua",
    "com.eg", "net.eg", "org.eg", "gov.eg", "edu.eg",
    "com.ng", "net.ng", "org.ng", "gov.ng", "edu.ng",
    "co.ke", "or.ke", "ne.ke", "go.ke", "ac.ke",
    # generic second-level registries
    "com.es", "nom.es", "org.es", "gob.es", "edu.es",
    "co.id", "or.id", "web.id", "ac.id", "go.id", "sch.id",
    "com.my", "net.my", "org.my", "edu.my", "gov.my",
    "com.ph", "net.ph", "org.ph", "edu.ph", "gov.ph",
    "com.vn", "net.vn", "org.vn", "edu.vn", "gov.vn",
    "co.th", "in.th", "or.th", "ac.th", "go.th", "net.th",
}


def format_domain(domain: str) -> str:
    """Lowercase + IDNA (punycode) normalization (tools.ts formatDomain)."""
    domain = (domain or "").lower().strip()
    try:
        domain = domain.encode("idna").decode("ascii").lower().strip()
    except (UnicodeError, UnicodeDecodeError):
        pass  # keep as-is on punycode errors, like the reference
    return domain


def psl_get(domain: str) -> str | None:
    """Registrable (organizational) domain, or None for a bare suffix/TLD.

    psl.get() role: "mail.google.com" -> "google.com",
    "a.b.co.uk" -> "b.co.uk", "com" -> None.
    """
    domain = (domain or "").lower().strip(".")
    if not domain:
        return None
    labels = domain.split(".")
    if len(labels) < 2:
        return None
    for take in (3, 2):  # longest matching public suffix wins
        if len(labels) >= take:
            suffix = ".".join(labels[-take:])
            if suffix in _MULTI_LABEL_SUFFIXES:
                return ".".join(labels[-(take + 1):]) if len(labels) > take else None
    return ".".join(labels[-2:])


def get_alignment(
    from_domain: str, domain_list: list[str] | str, strict: bool = False
) -> str | bool:
    """DMARC-style alignment of the From: domain against signing domains
    (tools.ts:466-487): strict requires an exact org-domain equality of the
    unreduced From domain first; relaxed matches organizational domains.
    Returns the aligned domain or False."""
    if isinstance(domain_list, str):
        domain_list = [domain_list]
    domain_list = list(domain_list or [])
    if strict:
        fd = format_domain(from_domain)
        for domain in domain_list:
            d = format_domain(psl_get(domain) or domain)
            if d == fd:
                return d
    fd = format_domain(psl_get(from_domain) or from_domain)
    for domain in domain_list:
        d = format_domain(psl_get(domain) or domain)
        if d == fd:
            return d
    return False


def escape_prop_value(value) -> str:
    """Authentication-Results property value: token, or quoted-string
    (tools.ts escapePropValue)."""
    value = re.sub(r"[\x00-\x1F]+", " ", str(value or ""))
    value = re.sub(r"\s+", " ", value).strip()
    if not re.search(r'[\s\x00-\x1F\x7F-￿()<>,;:\\"/\[\]?=]', value):
        return value
    return '"' + re.sub(r'(["\\])', r"\\\1", value) + '"'


def escape_comment_value(value) -> str:
    value = re.sub(r"[\x00-\x1F]+", " ", str(value or ""))
    value = re.sub(r"\s+", " ", value).strip()
    return re.sub(r"([\\)])", r"\\\1", value)


def format_auth_header_row(method: str, status: dict | None) -> str:
    """One Authentication-Results row: `dkim=pass (comment) header.i=...`
    (tools.ts formatAuthHeaderRow)."""
    status = status or {}
    parts = [f"{method}={status.get('result') or 'none'}"]
    if status.get("comment"):
        parts.append(f"({escape_comment_value(status['comment'])})")
    for ptype in ("policy", "smtp", "body", "header"):
        props = status.get(ptype)
        if not isinstance(props, dict):
            continue
        for prop, val in props.items():
            if val:
                parts.append(f"{ptype}.{prop}={escape_prop_value(val)}")
    return " ".join(parts)


def validate_algorithm(algorithm: str, strict: bool = False) -> None:
    """a= tag validation (tools.ts validateAlgorithm). Raises ValueError with
    .code = 'EINVALIDALGO' on failure."""

    def bad(msg):
        err = ValueError(msg)
        err.code = "EINVALIDALGO"
        return err

    if not algorithm or not re.match(r"^[^-]+-[^-]+$", algorithm):
        raise bad("Invalid algorithm format")
    sign_algo, hash_algo = algorithm.lower().split("-")
    if sign_algo not in ("rsa", "ed25519"):
        raise bad(f"Unknown signing algorithm: {sign_algo}")
    allowed = ("sha256",) if strict else ("sha256", "sha1")
    if hash_algo not in allowed:
        raise bad(f"Unknown hashing algorithm: {hash_algo}")
