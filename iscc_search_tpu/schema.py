"""
Wire schemas for the ISCC-Search API.

Pydantic v2 request/response models matching the reference's OpenAPI-generated
schema surface (reference iscc_search/schema.py: IsccIndex:18, IsccSimprint:45,
IsccQuery:95, IsccAddResult:147, IsccEntry:329, IsccGlobalMatch:384,
IsccChunkMatch:445, IsccSearchResult:533), including field constraints like
``units min_length=2`` and per-type simprint lists ``min_length=1``.
"""

from __future__ import annotations

from enum import Enum
from typing import Annotated, Any

from pydantic import BaseModel, ConfigDict, Field


class HttpError(BaseModel):
    detail: str | list[str]


class IsccIndex(BaseModel):
    name: Annotated[
        str,
        Field(
            description="Short unique name of the index (valid code identifier)",
            max_length=32,
            min_length=1,
            pattern="^[a-z][a-z0-9]*$",
        ),
    ]
    assets: Annotated[int | None, Field(description="Number of ISCCs in the index", ge=0)] = None
    size: Annotated[int | None, Field(description="Size of index in megabytes", ge=0)] = None
    sizes: Annotated[
        dict[str, Annotated[int, Field(ge=0)]] | None,
        Field(description="Size in megabytes per index component"),
    ] = None


class IsccSimprint(BaseModel):
    simprint: Annotated[
        str,
        Field(
            description="Base64-encoded simprint hash (headerless, variable length)",
            min_length=11,
            pattern="^[A-Za-z0-9+/_=-]+$",
        ),
    ]
    offset: Annotated[int, Field(ge=0, le=4294967295)]
    size: Annotated[int, Field(ge=0, le=4294967295)]


class IsccQuery(BaseModel):
    iscc_id: Annotated[str | None, Field(pattern="^ISCC:[A-Z2-7]{16}$")] = None
    iscc_code: Annotated[str | None, Field(pattern="^ISCC:[A-Z2-7]{16,}$")] = None
    units: Annotated[list[str] | None, Field(min_length=1)] = None
    simprints: Annotated[
        dict[str, Annotated[list[str], Field(min_length=1)]] | None,
        Field(description="Simprint groups for chunk-level matching (type -> base64 simprints)"),
    ] = None


class Status(str, Enum):
    created = "created"
    updated = "updated"


class IsccAddResult(BaseModel):
    iscc_id: Annotated[str, Field(pattern="^ISCC:[A-Z2-7]{16}$")]
    status: Status


class IsccMetadata(BaseModel):
    model_config = ConfigDict(extra="allow")
    name: str | None = None
    source: str | None = None


class IsccMatchedChunk(BaseModel):
    query: Annotated[str, Field(pattern="^[A-Za-z0-9+/_=-]+$")]
    match: Annotated[str, Field(pattern="^[A-Za-z0-9+/_=-]+$")]
    score: Annotated[float, Field(ge=0.0, le=1.0)]
    freq: Annotated[int, Field(ge=1)]
    offset: Annotated[int, Field(ge=0, le=4294967295)]
    size: Annotated[int, Field(ge=0, le=4294967295)]
    content: str | None = None


class IsccEntry(BaseModel):
    iscc_id: Annotated[str | None, Field(pattern="^ISCC:[A-Z2-7]{16}$")] = None
    iscc_code: Annotated[str | None, Field(pattern="^ISCC:[A-Z2-7]{16,}$")] = None
    units: Annotated[list[str] | None, Field(min_length=2)] = None
    simprints: Annotated[
        dict[str, Annotated[list[IsccSimprint], Field(min_length=1)]] | None,
        Field(description="Simprint groups for chunk-level indexing"),
    ] = None
    metadata: dict[str, Any] | None = None


class IsccGlobalMatch(BaseModel):
    iscc_id: Annotated[str, Field(pattern="^ISCC:[A-Z2-7]{16}$")]
    score: Annotated[float, Field(ge=0.0, le=1.0)]
    types: Annotated[dict[str, Annotated[float, Field(ge=0.0, le=1.0)]], Field(min_length=1)]
    metadata: IsccMetadata | None = None


class Types(BaseModel):
    score: Annotated[float, Field(ge=0.0, le=1.0)]
    matches: Annotated[int, Field(ge=0)]
    queried: Annotated[int, Field(ge=1)]
    chunks: list[IsccMatchedChunk] | None = None


class IsccChunkMatch(BaseModel):
    iscc_id: Annotated[str, Field(pattern="^ISCC:[A-Z2-7]{16}$")]
    score: Annotated[float, Field(ge=0.0, le=1.0)]
    types: Annotated[dict[str, Types], Field(min_length=1)]
    source: str | None = None
    metadata: IsccMetadata | None = None


class IsccSearchResult(BaseModel):
    query: IsccQuery
    global_matches: list[IsccGlobalMatch]
    chunk_matches: list[IsccChunkMatch] = []
