"""
OpenAPI 3.1 spec generation from the pydantic wire models.

The reference maintains modular YAML as the schema source of truth and
code-generates pydantic from it (SURVEY §2.1 "API spec"); here the direction
is inverted — the pydantic models are the source of truth and the spec is
derived, keeping a single definition while still serving /openapi.json for
docs and client generation.
"""

from __future__ import annotations

from pydantic.json_schema import models_json_schema

from iscc_search_tpu import __version__
from iscc_search_tpu.schema import (
    HttpError,
    IsccAddResult,
    IsccChunkMatch,
    IsccEntry,
    IsccGlobalMatch,
    IsccIndex,
    IsccQuery,
    IsccSearchResult,
)


def _ref(name):
    # type: (str) -> dict
    return {"$ref": f"#/components/schemas/{name}"}


def _json_content(schema):
    # type: (dict) -> dict
    return {"application/json": {"schema": schema}}


def build_openapi():
    # type: () -> dict
    """Build the OpenAPI 3.1 document for the REST surface."""
    models = [
        IsccIndex,
        IsccEntry,
        IsccQuery,
        IsccAddResult,
        IsccSearchResult,
        IsccGlobalMatch,
        IsccChunkMatch,
        HttpError,
    ]
    _, definitions = models_json_schema(
        [(m, "validation") for m in models], ref_template="#/components/schemas/{model}"
    )
    schemas = definitions.get("$defs", {})

    err = {"description": "Error", "content": _json_content(_ref("HttpError"))}
    name_param = {
        "name": "name",
        "in": "path",
        "required": True,
        "schema": {"type": "string", "pattern": "^[a-z][a-z0-9]*$"},
    }
    limit_param = {
        "name": "limit",
        "in": "query",
        "required": False,
        "schema": {"type": "integer", "default": 100, "minimum": 1},
    }

    paths = {
        "/indexes": {
            "get": {
                "operationId": "list_indexes",
                "tags": ["indexes"],
                "responses": {
                    "200": {
                        "description": "Indexes",
                        "content": _json_content({"type": "array", "items": _ref("IsccIndex")}),
                    }
                },
            },
            "post": {
                "operationId": "create_index",
                "tags": ["indexes"],
                "requestBody": {"required": True, "content": _json_content(_ref("IsccIndex"))},
                "responses": {
                    "201": {"description": "Created", "content": _json_content(_ref("IsccIndex"))},
                    "409": err,
                    "400": err,
                },
            },
        },
        "/indexes/{name}": {
            "get": {
                "operationId": "get_index",
                "tags": ["indexes"],
                "parameters": [name_param],
                "responses": {
                    "200": {"description": "Index metadata", "content": _json_content(_ref("IsccIndex"))},
                    "404": err,
                },
            },
            "delete": {
                "operationId": "delete_index",
                "tags": ["indexes"],
                "parameters": [name_param],
                "responses": {"204": {"description": "Deleted"}, "404": err},
            },
        },
        "/indexes/{name}/assets": {
            "post": {
                "operationId": "add_assets",
                "tags": ["assets"],
                "parameters": [name_param],
                "requestBody": {
                    "required": True,
                    "content": _json_content({"type": "array", "items": _ref("IsccEntry")}),
                },
                "responses": {
                    "201": {
                        "description": "Add results",
                        "content": _json_content({"type": "array", "items": _ref("IsccAddResult")}),
                    },
                    "404": err,
                    "400": err,
                },
            }
        },
        "/indexes/{name}/assets/{iscc_id}": {
            "get": {
                "operationId": "get_asset",
                "tags": ["assets"],
                "parameters": [
                    name_param,
                    {"name": "iscc_id", "in": "path", "required": True, "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {"description": "Asset", "content": _json_content(_ref("IsccEntry"))},
                    "404": err,
                    "400": err,
                },
            }
        },
        "/indexes/{name}/search": {
            "post": {
                "operationId": "search_post",
                "tags": ["search"],
                "parameters": [name_param, limit_param],
                "requestBody": {"required": True, "content": _json_content(_ref("IsccQuery"))},
                "responses": {
                    "200": {"description": "Search result", "content": _json_content(_ref("IsccSearchResult"))},
                    "404": err,
                    "400": err,
                },
            },
            "get": {
                "operationId": "search_get",
                "tags": ["search"],
                "parameters": [
                    name_param,
                    limit_param,
                    {"name": "iscc_code", "in": "query", "required": True, "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {"description": "Search result", "content": _json_content(_ref("IsccSearchResult"))},
                    "404": err,
                    "400": err,
                },
            },
        },
    }

    # Document auth and validation responses on every operation: without a
    # `security` requirement referencing the scheme, generated clients and
    # the /docs Try-It UI would never send X-API-Key and every call would
    # 401 on a secured deployment.
    for path_item in paths.values():
        for op in path_item.values():
            op["security"] = [{"ApiKeyAuth": []}, {}]  # optional: public mode has no secret
            op["responses"].setdefault("401", {"description": "Missing or invalid API key"})
            op["responses"].setdefault(
                "422", {"description": "Validation error", "content": _json_content(_ref("HttpError"))}
            )

    return {
        "openapi": "3.1.0",
        "info": {
            "title": "ISCC-Search API",
            "description": "Exact nearest-neighbor multi-index for the "
            "International Standard Content Code (ISCC)",
            "version": __version__,
        },
        "paths": paths,
        "components": {
            "schemas": schemas,
            "securitySchemes": {
                "ApiKeyAuth": {"type": "apiKey", "in": "header", "name": "X-API-Key"}
            },
        },
    }
